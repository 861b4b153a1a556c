"""zamba2-7b [hybrid] — Mamba2 backbone + weight-shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
[arXiv:2411.15242; unverified]

The reference's simplifications against the released model, kept here as
the JAX package has them: a single shared attention+MLP block (the release
alternates two) without per-invocation LoRA; the shared block's input is
concat(hidden, embedding) projected back to d_model.
"""
from repro_torch.configs import registry
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
        conv_width=4, hybrid_attn_every=6,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
        conv_width=4, hybrid_attn_every=2,
        remat=False,
    )


registry.register("zamba2-7b", full, smoke)
