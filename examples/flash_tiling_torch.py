"""Time two layouts of each of two bf16 flash forwards on one card, in
turns (kept, other, other, kept), each first held against the plain
version (2e-2 + 2e-2 |plain|):

- the d 256 form at gemma3-1b's local (window 512) and global (no window)
  serving shapes: one Q buffer with kv tiles of 64 rows (what the launcher
  takes) against two Q buffers with kv tiles of 32 rows (192 KB each);
- the d_qk 192 / d_v 128 form at deepseek-v3-671b's prefill shape: two Q
  buffers with a 3-stage ring of 64-row kv tiles (216 KB, what the
  launcher takes) against one Q buffer with a 4-stage ring (208 KB);
- the same form's work items with (n, head) slowest (what the kernel
  takes) against the d 64/128/256 forms' order, q tile slowest.

Run (card only):

    PYTHONPATH=src python examples/flash_tiling_torch.py

Each other layout is built from a copy of the kernel's ``csrc/`` that
takes it, under the kernel's gitignored ``build/`` folder;
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
# study -> (its shapes, the kept layout's source text, the other's, their
# labels)
STUDIES = {
    "d 256": ("d 256", "launch_wgmma256<64, 1>", "launch_wgmma256<32, 2>",
              ("64-row kv tiles, one Q buffer",
               "32-row kv tiles, two Q buffers")),
    "d_qk 192 / d_v 128": ("mla", "launch_wgmma192<2, 3>",
                           "launch_wgmma192<1, 4>",
                           ("two Q buffers, a 3-stage kv ring",
                            "one Q buffer, a 4-stage kv ring")),
    "d_qk 192 / d_v 128 items": ("mla", "wg192::item(w, nq, H, a)",
                                 "wg::item(w, nq, H, N, a)",
                                 ("(n, head) slowest", "q tile slowest")),
}


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

    kept_library = fa.LIBRARY
    libs = {}
    for n, (study, (_, kept, other, labels)) in enumerate(STUDIES.items()):
        copy = fa.SOURCE.parent.parent / "build" / f"tiling{n}" / "csrc"
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(fa.SOURCE.parent, copy)
        src = copy / fa.SOURCE.name
        text = src.read_text()
        if kept not in text:
            raise RuntimeError(f"the kernel no longer holds {kept}")
        src.write_text(text.replace(kept, other))
        libs[study] = {labels[0]: kept_library,
                       labels[1]: _build.Library(src, fa._bind)}
    cs.build_all({f"{study}: {label}": lib for study, pair in libs.items()
                  for label, lib in pair.items()})

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    bw = cs.card_bandwidth(name)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = {"d 256": (("local", cs.FLASH_SERVE_GEMMA3, None),
                        ("global", cs.FLASH_SERVE_GEMMA3_GLOBAL, None)),
              "mla": (("prefill", cs.FLASH_SERVE_MLA, cs.MLA_DV),)}
    out = {}
    for study, pair in libs.items():
        kept, other = pair
        for label, case, dv in shapes[STUDIES[study][0]]:
            kw = dict(causal=True, window=case[7])
            q, k, v = cs.flash_inputs(case, torch.bfloat16, gen, dev, dv)
            want = ref.flash_attention_ref(q, k, v, **kw).float()
            times = {key: [] for key in pair}
            for key in (kept, other, other, kept):
                fa.LIBRARY = pair[key]
                diff = (fa.flash_attention(q, k, v, **kw).float()
                        - want).abs()
                cs.check(bool((diff <= 2e-2 + 2e-2 * want.abs()).all()),
                         f"{study} {key} at {case}: max|kernel - plain| "
                         f"{diff.max().item()}")
                times[key].append(cs.time_ms(
                    lambda: fa.flash_attention(q, k, v, **kw), flush) * 1e3)
            fa.LIBRARY = kept_library
            bound = cs.work_bound(cs.flash_work(case, dv),
                                  bw)["bound_ms"] * 1e3
            out[f"{study}, {label}"] = dict(times, bound_us=bound)
            print(f"{study}, {label} {case[:6]} d_v {dv or case[5]} window "
                  f"{case[7]}: "
                  + "; ".join(f"{key} {t[0]:.2f}, {t[1]:.2f} us"
                              for key, t in times.items())
                  + f"; bound {bound:.2f} us", flush=True)
            del q, k, v, want
    print(json.dumps({"card": name, "tilings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
