"""deepseek-v3-671b [moe] — 61L d_model=7168 128H (MLA) moe_d_ff=2048
vocab=129280; 1 shared + 256 routed experts top-8, 3 leading dense layers
(dense d_ff=18432). MTP head omitted.
[arXiv:2412.19437; hf]
"""
from repro_torch.configs import registry
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432, vocab_size=129280,
        n_experts=256, n_experts_per_tok=8, n_shared_experts=1,
        moe_d_ff=2048, n_dense_layers=3,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab_size=256,
        n_experts=8, n_experts_per_tok=2, n_shared_experts=1,
        moe_d_ff=32, n_dense_layers=1,
        use_mla=True, q_lora_rank=48, kv_lora_rank=32,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, remat=False,
    )


registry.register("deepseek-v3-671b", full, smoke)
