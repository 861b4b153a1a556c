"""Launcher glue: build a session (config, runtime, parameters on the
device) for a stacked ``(data, model)`` or ``(pod, data, model)`` mesh,
and — given an ``OptConfig`` — the training session of the JAX package:
specs, gradient masks, optimizer state and the step functions that take a
global batch.

``build_session(cfg, tp, comm)`` keeps the serving call form: an int mesh
is ``(data=1, model=tp)``, and without ``oc`` no optimizer state is built.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.config import CommConfig
from repro_torch.device import deterministic, resolve_device
from repro_torch.models import sharding, transformer
from repro_torch.models.common import MeshContext, ModelConfig, Runtime
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts


@dataclasses.dataclass
class Session:
    cfg: ModelConfig
    tp: int
    rt: Runtime
    params: Any
    mesh: MeshContext = None
    param_spec: Any = None
    opt_spec: Any = None
    mask: Any = None
    oc: Optional[adamw.OptConfig] = None
    opt_state: Any = None
    ms_mask: Any = None
    device: Any = None


def build_session(cfg: ModelConfig, mesh, comm: CommConfig | str,
                  oc: Optional[adamw.OptConfig] = None, seed: int = 0,
                  device=None, tune_db_path=None, objective: str = "latency",
                  fsdp: bool = False, seq_parallel: bool = False) -> Session:
    """Initialise ``cfg``'s parameters from ``seed`` on the device (the card
    unless ``device`` names another) as stacked per-rank shards over the
    ``mesh`` (a ``MeshContext``, or the tensor-parallel size for ``(data=1,
    model=tp)``); each data rank holds a copy, or with ``fsdp`` its slice
    of every layer-stack weight (``sharding.build_fsdp_plan``, over the
    last data axis).  ``seq_parallel`` runs the dense blocks under
    Megatron-SP.  With ``oc`` the session trains: it carries the spec
    trees, the gradient masks and the optimizer state.

    ``comm="auto"`` asks the autotuner for the fastest measured config for
    the LM path's dominant collective — the per-layer row-parallel TP
    combine, a (tokens, d_model) f32 partial sum at a nominal 1K-token
    microbatch — on ``tp`` ranks of the device's platform, falling back to
    ``OPTIMIZED_CONFIG`` on a cold TuneDB.  ``objective="e2e"`` ranks by
    the measured ``row_parallel`` consumer-loop time."""
    mesh = (MeshContext.stacked(int(mesh)) if isinstance(mesh, int)
            else MeshContext.from_mesh(mesh))
    tp, dp = mesh.tp, mesh.dp
    dev = resolve_device(device)
    if not isinstance(comm, CommConfig):
        from repro_torch.core.collectives import resolve_config
        comm = resolve_config(comm, "all_reduce", 4 * cfg.d_model * 1024,
                              n_ranks=tp, db_path=tune_db_path,
                              objective=objective, consumer="row_parallel",
                              device=dev)
    full = transformer.init_model(seed, cfg, tp, dev)
    plan = sharding.build_fsdp_plan(full, cfg, mesh) if fsdp else None
    rt = Runtime(cfg=cfg, mesh=mesh, comm=comm, fsdp_plan=plan,
                 seq_parallel=seq_parallel)
    sess = Session(cfg=cfg, tp=tp, rt=rt, params=None, mesh=mesh,
                   device=dev)
    sess.params = stacked_params(sess, full)
    if oc is None:
        return sess
    sess.oc = oc
    sess.param_spec = sharding.param_specs(full, cfg, mesh, fsdp=fsdp)
    del full
    sess.mask = sharding.grad_model_sum_mask(sess.params, cfg, tp,
                                             seq_parallel=seq_parallel)
    sess.ms_mask = sharding.model_sharded_mask(sess.param_spec)
    sess.opt_spec = adamw.state_specs(sess.param_spec, oc, rt, plan)
    sess.opt_state = init_opt_state(sess)
    return sess


def init_opt_state(sess: Session):
    return adamw.init_state(sess.params, sess.oc, sess.rt, sess.rt.fsdp_plan)


def _fsdp_dp(sess: Session) -> int:
    """The FSDP data factor: the last data axis's size, 1 without FSDP."""
    return 1 if sess.rt.fsdp_plan is None else sess.mesh.data_sizes[-1]


# ----------------------------------------------------------------------
# Global (unsharded) trees: the checkpoint's layout
# ----------------------------------------------------------------------

def global_params(sess: Session, params=None):
    """The full parameter arrays (the JAX package's global values) of the
    stacked shards."""
    return sharding.unshard_params(sess.params if params is None else params,
                                   sess.cfg, sess.tp, sess.rt.fsdp_plan,
                                   _fsdp_dp(sess))


def stacked_params(sess: Session, full):
    """Full arrays -> the session's stacked shards on its device."""
    return sharding.shard_params(full, sess.cfg, sess.tp, sess.device,
                                 dp=sess.mesh.dp, fsdp_dp=_fsdp_dp(sess))


def global_opt_state(sess: Session, state=None):
    """The optimizer state in the JAX package's global layout: moment trees
    unsharded like the parameters, or zero1 slices ``(tp, dp, k)`` and the
    FSDP leaves' moments unsharded."""
    state = sess.opt_state if state is None else state
    if "m_slice" in state:
        return {"m_slice": adamw.global_slices(state["m_slice"], sess.rt),
                "v_slice": adamw.global_slices(state["v_slice"], sess.rt),
                "m_fsdp": global_params(sess, state["m_fsdp"]),
                "v_fsdp": global_params(sess, state["v_fsdp"]),
                "step": state["step"]}
    return {"m": global_params(sess, state["m"]),
            "v": global_params(sess, state["v"]), "step": state["step"]}


def stacked_opt_state(sess: Session, state):
    """Inverse of :func:`global_opt_state`, on the session's device."""
    step = state["step"].to(device=sess.device, dtype=torch.int32)
    if "m_slice" in state:
        return {k: adamw.stacked_slices(state[k].to(sess.device), sess.rt)
                for k in ("m_slice", "v_slice")} | {
                    k: stacked_params(sess, state[k])
                    for k in ("m_fsdp", "v_fsdp")} | {"step": step}
    return {"m": stacked_params(sess, state["m"]),
            "v": stacked_params(sess, state["v"]), "step": step}


# ----------------------------------------------------------------------
# Sharded step functions
# ----------------------------------------------------------------------

def shard_batch(sess: Session, batch: dict) -> dict:
    """A global batch ``{"tokens", "labels"}`` of ``(B, S)`` (numpy or
    tensors) -> the stacked ``(P, B / dp, S)`` long tensors on the
    session's device: data rank ``r`` (row-major over the data axes, pods
    included, as the JAX package's ``P(("pod", "data"))``) takes rows ``[r
    B/dp, (r+1) B/dp)``, repeated over its model group."""
    dp, tp = sess.mesh.dp, sess.mesh.tp
    out = {}
    for k in ("tokens", "labels"):
        x = torch.as_tensor(np.asarray(batch[k])).to(sess.device,
                                                     torch.long)
        B = x.shape[0]
        if B % dp:
            raise ValueError(f"global batch {B} does not split over {dp} "
                             f"data ranks")
        x = x.reshape((dp, B // dp) + tuple(x.shape[1:]))
        out[k] = x.repeat_interleave(tp, dim=0)
    return out


def make_sharded_train_step(sess: Session, accum_steps: int = 1,
                            donate: bool = True):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    over a global batch, which it cuts over the data ranks
    (:func:`shard_batch`).  Runs under deterministic algorithms.  The JAX
    package's version returns a function of the batch's spec that makes
    the step; here the batch layout is fixed, so the step is returned
    directly.  ``donate``
    lets the step overwrite the optimizer state it is given (zero1: the
    moments are updated in place)."""
    fn = ts.make_train_step(sess.rt, sess.oc, sess.mask, accum_steps,
                            ms_mask=sess.ms_mask, donate=donate)

    def step(params, opt_state, batch):
        with deterministic():
            return fn(params, opt_state, shard_batch(sess, batch))
    return step


def make_sharded_eval_step(sess: Session):
    fn = ts.make_eval_step(sess.rt)

    def step(params, batch):
        with deterministic():
            return fn(params, shard_batch(sess, batch))
    return step
