"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768; 8 experts top-2, SWA. [arXiv:2401.04088; hf]

EP layout on tp=16: each expert split into 2 ff-shards across device pairs
(EP8 × TP2 flattened over the model axis).
"""
from repro_torch.configs import registry
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768, head_dim=128,
        n_experts=8, n_experts_per_tok=2, moe_d_ff=16384,
        sliding_window=4096, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        n_experts=4, n_experts_per_tok=2, moe_d_ff=128,
        sliding_window=32, remat=False,
    )


registry.register("mixtral-8x22b", full, smoke)
