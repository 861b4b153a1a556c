"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144; 5:1 local:global attention, 512-token sliding window.
[hf:google/gemma-3-1b-pt; unverified]

With 4 heads on tp=16 the attention computes replicated (shard_attn=
"replicate") in the baseline — the deliberately paper-representative cell:
dispatch/latency overheads dominate a tiny model, and the perf log flips this
to padded head sharding.
"""
from repro_torch.configs import registry
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
        d_ff=6912, vocab_size=262144, head_dim=256,
        local_global_ratio=5, sliding_window=512,
        rope_theta=1_000_000.0, shard_attn="replicate",
        qk_norm=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab_size=256, head_dim=16,
        local_global_ratio=2, sliding_window=16, qk_norm=True, remat=False,
    )


registry.register("gemma3-1b", full, smoke)
