"""The port's checkpointer: round trip, torn steps, async and emergency
saves, and the on-disk format shared with the JAX package's
``Checkpointer`` — a checkpoint written by either restores in the other to
the same values (one 1-device JAX subprocess, qwen3's smoke config in
bf16, so the bf16 -> f32 widening is exercised both ways)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                 Checkpointer, emergency_save)
from repro_torch.configs import get_smoke_config
from repro_torch.core.config import CommConfig
from repro_torch.launch import mesh as mesh_mod, setup
from repro_torch.models import sharding
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim import adamw

CFG = get_smoke_config("qwen3-8b")          # bf16


def _tree():
    return {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16) / 3,
                  "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ck = Checkpointer(tmp_path)
    ck.save(7, tree)
    assert ck.latest_step() == 7
    out = ck.restore(7, tree)
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["step"].dtype == torch.int32 and int(out["b"]["step"]) == 7
    # the format: sorted '/'-joined names, bf16 stored widened to f32
    with np.load(tmp_path / "ckpt_00000007.npz") as data:
        assert sorted(data.files) == ["a", "b/c", "b/step"]
        assert data["b/c"].dtype == np.float32
    manifest = json.loads((tmp_path / "manifest_00000007.json").read_text())
    assert manifest["step"] == 7
    assert (tmp_path / "ckpt_00000007.COMMIT").exists()
    # reshard maps the restored full tree onto a layout
    doubled = ck.restore(7, tree, reshard=lambda t: {**t, "a": t["a"] * 2})
    assert torch.equal(doubled["a"], tree["a"] * 2)


def test_torn_step_is_skipped_and_counted(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(3, _tree())
    ck.save(5, _tree())
    os.remove(tmp_path / "ckpt_00000005.COMMIT")       # crash before COMMIT
    (tmp_path / "ckpt_00000009.123.tmp.npz").write_bytes(b"")  # leaked tmp
    c = obs_metrics.registry().counter("ckpt.skipped_partial")
    before = c.value
    assert ck.latest_step() == 3
    assert ck.latest_step() == 3
    assert c.value == before + 1                       # counted once
    assert Checkpointer(tmp_path / "empty").latest_step() is None


def test_async_checkpoint_and_emergency(tmp_path):
    tree = {"w": torch.full((256,), 3.0)}
    ck = AsyncCheckpointer(tmp_path)
    ck.save(1, tree)
    tree["w"].fill_(4.0)      # the snapshot was taken before the write
    ck.wait()
    assert ck.latest_step() == 1 and ck.pending == 0
    assert float(ck.restore(1, tree)["w"][0]) == 3.0
    opt = {"m": torch.ones(4), "step": torch.tensor(2, dtype=torch.int32)}
    emergency_save(tmp_path, 2, tree, opt_state=opt)
    assert ck.latest_step() == 2
    manifest = json.loads((tmp_path / "manifest_00000002.json").read_text())
    assert manifest["emergency"] is True
    back = Checkpointer(tmp_path / "opt").restore(2, opt)
    assert torch.equal(back["m"], opt["m"]) and int(back["step"]) == 2


def test_session_state_roundtrip_through_the_global_layout(tmp_path):
    """A (2, 2) session's params and ZeRO-1 state leave in the JAX
    package's global layout and come back onto the stacked one exactly."""
    cfg = dataclasses.replace(CFG, dtype=torch.float32)
    sess = setup.build_session(cfg, mesh_mod.make_test_mesh(2, 2),
                               CommConfig(), oc=adamw.OptConfig(zero1=True),
                               device="cpu")
    g = torch.Generator().manual_seed(0)
    sess.opt_state["m_slice"].normal_(generator=g)
    emergency_save(tmp_path, 4, setup.global_params(sess),
                   opt_state=setup.global_opt_state(sess))
    glob = setup.global_opt_state(sess)
    assert tuple(glob["m_slice"].shape) == (2, 2,
                                            sess.opt_state["m_slice"].shape[1])
    params = Checkpointer(tmp_path).restore(
        4, setup.global_params(sess),
        reshard=lambda t: setup.stacked_params(sess, t))
    state = Checkpointer(tmp_path / "opt").restore(
        4, glob, reshard=lambda t: setup.stacked_opt_state(sess, t))
    for (_, a), (_, b) in zip(adamw.leaves_with_names(params),
                              adamw.leaves_with_names(sess.params)):
        assert torch.equal(a, b)
    assert torch.equal(state["m_slice"], sess.opt_state["m_slice"])


JAX_CODE = """
import json
import jax, numpy as np
from repro.checkpoint.checkpointer import Checkpointer
from repro.configs.registry import get_smoke_config
from repro.core.config import CommConfig
from repro.launch import setup

spec = json.loads(SPEC)
cfg = get_smoke_config("qwen3-8b")
mesh = jax.make_mesh((1, 1), ("data", "model"))
sess = setup.build_session(cfg, mesh, CommConfig(), concrete=True)
params = jax.device_get(sess.params)
Checkpointer(spec["jax_dir"]).save(5, params)
back = Checkpointer(spec["port_dir"]).restore(6, params)
def flat(tree, prefix):
    return {prefix + "/".join(str(p.key) for p in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
assert all(str(l.dtype) == "bfloat16" for l in jax.tree.leaves(back))
np.savez(spec["out"], **flat(params, "jax/"), **flat(back, "back/"))
print("JAX CKPT OK")
"""


def _tree_of(flat, prefix):
    out: dict = {}
    for key, value in flat.items():
        if key.startswith(prefix):
            node = out
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
    return out


def test_checkpoints_interoperate_with_the_jax_package(tmp_path):
    """The JAX package's checkpoint restores in the port (onto a (2, 2)
    stack) to exactly ``from_reference`` of its params; the port's restores
    in the JAX package to exactly the port's params."""
    sess = setup.build_session(CFG, mesh_mod.make_test_mesh(2, 2),
                               CommConfig(), seed=3, device="cpu")
    Checkpointer(tmp_path / "port").save(6, setup.global_params(sess))
    spec = {"jax_dir": str(tmp_path / "jax"), "port_dir": str(tmp_path / "port"),
            "out": str(tmp_path / "out.npz")}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=1)
    assert "JAX CKPT OK" in out
    ref = dict(np.load(tmp_path / "out.npz"))
    jax_params = _tree_of(ref, "jax/")
    ck = Checkpointer(tmp_path / "jax")
    assert ck.latest_step() == 5
    got = ck.restore(5, setup.global_params(sess),
                     reshard=lambda t: setup.stacked_params(sess, t))
    want = sharding.shard_params(
        adamw.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                       jax_params), CFG, 2, dp=2)
    for (n, a), (_, b) in zip(adamw.leaves_with_names(got),
                              adamw.leaves_with_names(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), n
    back = _tree_of(ref, "back/")
    for (n, a), (_, b) in zip(
            adamw.leaves_with_names(setup.global_params(sess)),
            adamw.leaves_with_names(back)):
        assert torch.equal(a.float(), torch.from_numpy(b)), n


def test_resume_without_a_checkpoint_raises(tmp_path):
    from repro_torch.runtime.fault_tolerance import resume_session
    sess = setup.build_session(dataclasses.replace(CFG, dtype=torch.float32),
                               1, CommConfig(), oc=adamw.OptConfig(),
                               device="cpu")
    with pytest.raises(FileNotFoundError):
        resume_session(tmp_path / "missing", sess)
