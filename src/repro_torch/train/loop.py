"""Production training loop (PyTorch port): data prefetch + async
checkpoints + watchdog + preemption drain + fault injection, over the
sharded train step."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                 emergency_save)
from repro_torch.data.pipeline import DataConfig, PrefetchLoader, SyntheticLM
from repro_torch.launch import setup as setup_mod
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.fault_tolerance import PreemptionGuard, StepWatchdog


@dataclasses.dataclass
class LoopConfig:
    n_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    accum_steps: int = 1


def _drain(sess, loop: LoopConfig, step: int, params, opt_state=None
           ) -> None:
    """Emergency checkpoint of ``params`` (and of the optimizer state when
    given), in the global layout, at ``step``."""
    if loop.ckpt_dir:
        emergency_save(loop.ckpt_dir, step,
                       setup_mod.global_params(sess, params),
                       opt_state=None if opt_state is None
                       else setup_mod.global_opt_state(sess, opt_state))


def train(sess: setup_mod.Session, data_cfg: DataConfig, loop: LoopConfig,
          log: Callable[[str], None] = print,
          guard: Optional[PreemptionGuard] = None,
          faults=None, grad_norms: Optional[list] = None) -> list:
    """Run the training loop -> the loss of every step taken (and each
    step's global gradient norm appended to ``grad_norms`` when given).

    ``guard`` lets a caller share one :class:`PreemptionGuard` (or pre-arm
    a software drain with ``guard.request()``); by default the loop
    installs its own.  ``faults`` (a
    :class:`repro_torch.runtime.faults.FaultInjector`) is polled at every
    step boundary: stragglers inject host delay, ``Preempt`` requests the
    drain, and ``RankLost`` raises
    :class:`~repro_torch.runtime.faults.RankLostError` out of the loop after
    an emergency checkpoint of the last completed step's params, so the
    elastic restart (``elastic_restore``) resumes from exactly where the
    rank died.  That save leaves out the optimizer state, which the JAX
    package's loop writes too: the restart never reads it (its ZeRO slices
    belong to the dead mesh), and at full width it is two thirds of the
    bytes.

    A preemption drain saves the optimizer state beside the params: a same-mesh
    :func:`~repro_torch.runtime.fault_tolerance.resume_session` continues
    with identical Adam moments, bitwise equal to an uninterrupted run."""
    step_fn = setup_mod.make_sharded_train_step(
        sess, accum_steps=loop.accum_steps, donate=True)
    cc = sess.rt.comm
    log(f"[comm] mode={cc.mode.value} scheduling={cc.scheduling.value} "
        f"transport={cc.transport.value} algorithm={cc.algorithm}")

    source = SyntheticLM(data_cfg)
    start_step = int(sess.opt_state["step"])
    loader = PrefetchLoader(source, start_step=start_step)
    ckpt = AsyncCheckpointer(loop.ckpt_dir) if loop.ckpt_dir else None
    watchdog = StepWatchdog()
    params, opt_state = sess.params, sess.opt_state
    # the session lets go of the tensors the steps replace (the JAX
    # package donates them), and gets the newest back on every exit
    sess.params = sess.opt_state = None
    history = []

    own_guard = guard is None
    if own_guard:
        guard = PreemptionGuard()
        guard.__enter__()
    try:
        for i in range(start_step, start_step + loop.n_steps):
            if faults is not None:
                try:
                    faults.poll(i, guard=guard)
                except Exception:
                    # rank death: checkpoint the last completed step, then
                    # let the error unwind to the caller's recovery
                    if ckpt:
                        ckpt.wait()
                    _drain(sess, loop, i, params)
                    raise
            if guard.preempted:
                log(f"[preempt] draining at step {i}")
                if ckpt:
                    ckpt.wait()   # an async save of this step may be writing
                _drain(sess, loop, i, params, opt_state)
                break
            batch = next(loader)
            watchdog.start_step(i)
            with obs_trace.span("train.step", cat="train", step=i):
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])    # waits for the step
            ev = watchdog.end_step()
            if ev is not None:
                log(f"[straggler] step {ev.step}: {ev.duration*1e3:.1f}ms "
                    f"(threshold {ev.threshold*1e3:.1f}ms)")
            history.append(loss)
            if grad_norms is not None:
                grad_norms.append(float(metrics["grad_norm"]))
            if i % loop.log_every == 0:
                log(f"step {i}: loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"lr={float(metrics['lr']):.2e}")
            if ckpt and (i + 1) % loop.ckpt_every == 0:
                ckpt.save(i + 1, setup_mod.global_params(sess, params))
            if guard.preempted:
                log(f"[preempt] draining at step {i}")
                if ckpt:
                    ckpt.wait()
                _drain(sess, loop, i + 1, params, opt_state)
                break
    finally:
        sess.params, sess.opt_state = params, opt_state
        if own_guard:
            guard.__exit__(None, None, None)
        if ckpt:
            ckpt.wait()
        loader.close()
    return history
