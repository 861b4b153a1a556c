"""Model configuration and the mesh/runtime context of the LM path
(PyTorch port).

The model substrate is manual SPMD on the stacked-rank backend: every
tensor carries the ranks of the ``(data, model)`` mesh as its leading
dimension, row-major (``x[p]`` is rank ``p``'s value: data rank
``p // tp``, model rank ``p % tp``), and every cross-rank
transfer is an explicit ACCL-X collective (:mod:`repro_torch.core`) — the
row-parallel combines, the vocab-sharded embedding and sampling, the K/V
all-gather of prefill and the log-sum-exp combine of sequence-parallel
decode all route through the same ``CommConfig``.

Sharding layout (Megatron-style, as in the JAX package):
  - weights over ``"model"`` (column -> row parallel with one combine);
  - the decode KV cache over ``"model"`` along the *sequence* axis
    (sequence-parallel decode with a log-sum-exp combine);
  - activations replicated across ``"model"`` between blocks, i.e. equal
    on every row of the rank dimension.
The data axis is size 1 on one card.

``ModelConfig`` keeps every field of the JAX package's class so that
configurations carry over unchanged; ``dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.communicator import Communicator
from repro_torch.core.config import CommConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    mlp_type: str = "swiglu"        # swiglu | gelu
    attention_bias: bool = False
    # Attention pattern
    causal: bool = True
    sliding_window: Optional[int] = None     # SWA width (mixtral, gemma local)
    local_global_ratio: int = 0              # gemma3: 5 local then 1 global
    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: Optional[int] = None
    n_dense_layers: int = 0                  # leading dense layers (dsv3: 3)
    capacity_factor: float = 1.25
    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4
    ssm_groups: int = 1
    # Hybrid (zamba2): one shared attention block applied every k ssm layers
    hybrid_attn_every: int = 0
    # Encoder-decoder (seamless)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # Multimodal frontend stubs
    frontend: Optional[str] = None           # vision | audio
    num_patches: int = 0                     # vision tokens per image
    frontend_dim: int = 0                    # raw frame/patch embedding width
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # Attention TP strategy when n_heads % tp != 0:
    #   "auto"      — pad q heads to `padded_heads` zero-weight heads
    #                 (identity math; small FLOP overhead, e.g. 56→64)
    #   "replicate" — compute attention replicated on every tp rank (tiny
    #                 models; 16x attention FLOP waste, a hillclimb lever)
    shard_attn: str = "auto"
    # Explicit padded head count (config-level so the GQA grouping is
    # identical at every tp, including tp=1). Must be a multiple of
    # n_kv_heads and of every tp used in production.
    padded_heads: Optional[int] = None
    # Which sub-modules are tensor-parallel (auto-disabled when the dimension
    # does not divide by tp; the fallback is replicated compute — recorded as
    # FLOP waste in the roofline's MODEL_FLOPS/HLO_FLOPS ratio).
    remat: bool = True
    # "full" recomputes everything in backward; "dots" saves matmul outputs
    # and recomputes only elementwise ops (selective checkpointing — trades
    # HBM for the recompute FLOPs; the §Perf lever for compute-bound cells).
    remat_policy: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def _ssm_params(self) -> int:
        d, di = self.d_model, self.d_inner
        gn = self.ssm_groups * self.ssm_state
        nh = self.ssm_heads
        return (2 * d * di + 2 * d * gn + d * nh + self.conv_width * di
                + di + di * d + 3 * nh + d)

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.use_mla:
            attn = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.qk_rope_dim)
            attn += d * (self.kv_lora_rank + self.qk_rope_dim)
            attn += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
            attn += self.n_heads * self.v_head_dim * d
        else:
            attn = d * (n_q + 2 * n_kv) + n_q * d
        def mlp_params(ff):  # noqa: E306
            return d * ff * (3 if self.mlp_type == "swiglu" else 2)
        if self.family in ("ssm",):
            ssm = self._ssm_params()
            return emb + self.n_layers * ssm
        if self.family == "hybrid":
            n_shared = self.n_layers // max(1, self.hybrid_attn_every)
            shared_block = attn + mlp_params(self.d_ff) + 2 * d * d  # concat proj
            return emb + self.n_layers * self._ssm_params() + shared_block
        core = 0
        n_moe_layers = 0
        if self.n_experts:
            n_moe_layers = self.n_layers - self.n_dense_layers
            ff = self.moe_d_ff or self.d_ff
            core += n_moe_layers * (
                self.n_experts * mlp_params(ff)
                + self.n_shared_experts * mlp_params(ff)
                + d * self.n_experts)
            core += self.n_dense_layers * mlp_params(self.d_ff)
        else:
            core += self.n_layers * mlp_params(self.d_ff)
        core += self.n_layers * attn
        n_enc = self.n_encoder_layers if self.is_encoder_decoder else 0
        core += n_enc * (attn + mlp_params(self.d_ff))   # encoder stack
        core += n_enc * attn                              # cross attention
        return emb + core


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """Static view of the stacked ``(data, model)`` mesh, or ``(pod, data,
    model)`` with two data axes: ``dp · tp`` ranks on the leading dimension
    of every tensor, row-major over ``(*data_axes, axis_model)``; ``dp`` is
    the product of the data axes."""
    axis_model: str = "model"
    data_axes: Tuple[str, ...] = ("data",)
    model_size: int = 1
    data_sizes: Tuple[int, ...] = (1,)

    @property
    def tp(self) -> int:
        return self.model_size

    @property
    def dp(self) -> int:
        out = 1
        for s in self.data_sizes:
            out *= s
        return out

    @property
    def n_ranks(self) -> int:
        """Rows of the stacked rank dimension."""
        return self.dp * self.tp

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.data_axes) + (self.axis_model,)

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape`` gives them."""
        return dict(zip(self.axis_names,
                        tuple(self.data_sizes) + (self.model_size,)))

    @classmethod
    def stacked(cls, tp: int, dp: int = 1) -> "MeshContext":
        """The ``(data=dp, model=tp)`` mesh of the stacked-rank backend."""
        return cls(model_size=tp, data_sizes=(dp,))

    @classmethod
    def from_mesh(cls, mesh, axis_model: str = "model") -> "MeshContext":
        """From anything with ``axis_names`` and a ``shape`` mapping (a
        ``MeshContext`` itself, or the JAX package's ``Mesh``)."""
        data_axes = tuple(a for a in mesh.axis_names if a != axis_model)
        return cls(axis_model=axis_model, data_axes=data_axes,
                   model_size=mesh.shape[axis_model],
                   data_sizes=tuple(mesh.shape[a] for a in data_axes))


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Everything a model function needs besides params and inputs.

    The JAX package's ``use_pallas`` has no counterpart: the attention
    kernel is chosen by the tensors' device (the CUDA kernel on the card,
    its plain version on the CPU)."""
    cfg: ModelConfig
    mesh: MeshContext
    comm: CommConfig
    # Decode KV-timeline shard axes: the model axis (the data axis is 1).
    seq_axes: tuple = ("model",)
    # FSDP gather plan from sharding.build_fsdp_plan (None = params fully
    # materialized per their TP spec; no per-layer gathers).
    fsdp_plan: Any = None
    # Megatron-SP: the residual stream sequence-sharded over the model axis
    # between blocks (norms on shards; all-gather before QKV/MLP-in,
    # reduce-scatter after the row-parallel matmul). Dense family.
    seq_parallel: bool = False

    def _axis_comm(self, axes) -> Communicator:
        return Communicator.from_mesh(self.mesh, tuple(axes))

    def sp_comm(self) -> Communicator:
        return self._axis_comm(self.seq_axes)

    @property
    def sp_size(self) -> int:
        return self.sp_comm().size

    def tp_comm(self) -> Communicator:
        """The model-axis groups: ``tp`` contiguous rows each."""
        return self._axis_comm((self.mesh.axis_model,))

    def dp_comm(self) -> Communicator:
        """The data-axis groups: rows strided by ``tp``."""
        return self._axis_comm(self.mesh.data_axes)
