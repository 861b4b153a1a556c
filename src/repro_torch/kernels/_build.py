"""One ``nvcc`` build path for every hand-written kernel of the port.

Each kernel folder holds a ``csrc/*.cu`` source with a plain C interface.
:class:`Library` compiles it at first use for ``sm_90a`` into a shared
library under that folder's ``build/`` (gitignored), named by the source's
hash so an edited source never loads a stale build, and loads it with
``ctypes``.  The flags leave out ``--use_fast_math``: the kernels' divisions,
square roots and roundings must be IEEE, as the JAX package's are.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           "the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


class Library:
    """A kernel source built once per process and bound through ``ctypes``.

    ``bind(lib)`` sets the ``argtypes``/``restype`` of the library's entry
    points.  After :meth:`load`, ``log`` holds what the build printed
    (``-Xptxas -v``: registers, spills) and ``seconds`` what it took; both
    stay empty when an earlier process had built the same source."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self.build_dir = self.source.parent.parent / "build"
        self.bind = bind
        self.log = ""
        self.seconds = 0.0
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
            so = self.build_dir / f"lib{self.source.stem}-{digest}.so"
            if not so.exists():
                self.build_dir.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {self.source.name}:\n"
                        f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)   # atomic: concurrent builders never clash
                self.seconds = time.perf_counter() - t0
                self.log = proc.stdout + proc.stderr
            lib = ctypes.CDLL(str(so))
            self.bind(lib)
            self._lib = lib
            return lib
