"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000; GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01;
unverified]"""
from repro_torch.configs import registry
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=33792, vocab_size=256000, head_dim=128,
        attention_bias=False, rope_theta=75_000_000.0, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=192, vocab_size=256, head_dim=16, padded_heads=8, remat=False,
    )


registry.register("command-r-plus-104b", full, smoke)
