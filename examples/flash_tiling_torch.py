"""Time the two shared-memory layouts of the d 256 flash forward on one
card: one Q buffer with kv tiles of 64 rows (what the launcher takes) and
two Q buffers with kv tiles of 32 rows (192 KB each), at gemma3-1b's local
(window 512) and global (no window) serving shapes, bf16, in turns (kept,
other, other, kept); each layout is first held against the plain version
(2e-2 + 2e-2 |plain|).

Run (card only):

    PYTHONPATH=src python examples/flash_tiling_torch.py

The other layout is built from a copy of the kernel's ``csrc/`` whose
launcher takes it, under the kernel's gitignored ``build/`` folder;
timings are ``chip_smoke.py``'s (CUDA events, the L2 flushed before each
launch, the median of 60).  The last line is one JSON object of the
readings.
"""
from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
KEPT, OTHER = "launch_wgmma256<64, 1>", "launch_wgmma256<32, 2>"


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_tiling_torch: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa, ref

    copy = fa.SOURCE.parent.parent / "build" / "tiling" / "csrc"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(fa.SOURCE.parent, copy)
    src = copy / fa.SOURCE.name
    text = src.read_text()
    if KEPT not in text:
        raise RuntimeError(f"the launcher no longer takes {KEPT}")
    src.write_text(text.replace(KEPT, OTHER))
    libs = {"64-row kv tiles, one Q buffer": fa.LIBRARY,
            "32-row kv tiles, two Q buffers": _build.Library(src, fa._bind)}
    cs.build_all(libs)
    kept, other = libs

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    bw = cs.card_bandwidth(name)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for label, case in (("local", cs.FLASH_SERVE_GEMMA3),
                        ("global", cs.FLASH_SERVE_GEMMA3_GLOBAL)):
        kw = dict(causal=True, window=case[7])
        q, k, v = cs.flash_inputs(case, torch.bfloat16, gen, dev)
        want = ref.flash_attention_ref(q, k, v, **kw).float()
        times = {key: [] for key in libs}
        for key in (kept, other, other, kept):
            fa.LIBRARY = libs[key]
            diff = (fa.flash_attention(q, k, v, **kw).float() - want).abs()
            cs.check(bool((diff <= 2e-2 + 2e-2 * want.abs()).all()),
                     f"{key} at {case}: max|kernel - plain| "
                     f"{diff.max().item()}")
            times[key].append(cs.time_ms(
                lambda: fa.flash_attention(q, k, v, **kw), flush) * 1e3)
        fa.LIBRARY = libs[kept]
        bound = cs.work_bound(cs.flash_work(case), bw)["bound_ms"] * 1e3
        out[label] = dict(times, bound_us=bound)
        print(f"{label} {case[:6]} window {case[7]}: "
              + "; ".join(f"{key} {t[0]:.2f}, {t[1]:.2f} us"
                          for key, t in times.items())
              + f"; bound {bound:.2f} us", flush=True)
        del q, k, v, want
    print(json.dumps({"card": name, "tilings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
