"""mamba2-130m [ssm] — 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128; SSD (state-space duality). [arXiv:2405.21060; unverified]

d_inner = 1536 -> 24 SSD heads of 64; heads are not divisible by tp=16 so the
SSM compute is replicated across the model axis (tiny model; recorded as
waste in the roofline MODEL/HLO ratio — embeddings/logits still shard).
"""
from repro_torch.configs import registry
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
        conv_width=4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=256,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
        conv_width=4, remat=False,
    )


registry.register("mamba2-130m", full, smoke)
