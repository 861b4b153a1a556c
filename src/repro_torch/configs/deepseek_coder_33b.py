"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256; llama-arch. [arXiv:2401.14196; hf]

56 heads do not divide tp=16: attention uses zero-padded head sharding
(56 -> 64 effective heads; identity math, ~14 % extra attention FLOPs —
recorded in the roofline's MODEL/HLO ratio).
"""
from repro_torch.configs import registry
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", family="dense",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=19200, vocab_size=32256, head_dim=128,
        rope_theta=100_000.0, shard_attn="auto", padded_heads=64,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-smoke", family="dense",
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
        d_ff=112, vocab_size=256, head_dim=8, shard_attn="auto",
        padded_heads=8, remat=False,
    )


registry.register("deepseek-coder-33b", full, smoke)
