"""One ``nvcc`` build path for every hand-written kernel of the port.

Each kernel folder holds a ``csrc/*.cu`` source with a plain C interface,
and may hold headers (``*.cuh``) beside it.  :class:`Library` compiles it
at first use for ``sm_90a`` into a shared library under that folder's
``build/`` (gitignored), named by a hash of every file under ``csrc/``, of
the headers it includes from elsewhere (``includes``) and of
``NVCC_FLAGS``, so an edited source or header never loads a stale build,
and loads it with ``ctypes``.  The flags leave out ``--use_fast_math``: the
kernels' divisions, square roots and roundings must be IEEE, as the JAX package's are.
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
    (``-Xptxas -v``: registers, spills), saved beside the library and read
    back when an earlier process had built the same sources, and
    ``seconds`` what the build took (0 when it was not built here).
    ``includes`` names the files outside ``csrc/`` that the source includes
    (hashed with it)."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None],
                 includes: tuple = ()):
        self.source = Path(source)
        self.build_dir = self.source.parent.parent / "build"
        self.bind = bind
        self.includes = tuple(Path(f) for f in includes)
        self.log = ""
        self.seconds = 0.0
        self._lib = None
        self._lock = threading.Lock()

    def digest(self) -> str:
        """Hash of ``NVCC_FLAGS``, of every file under the source's folder
        and of ``includes`` (names and contents), which names the build."""
        h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
        files = [(f.relative_to(self.source.parent).as_posix(), f)
                 for f in sorted(p for p in self.source.parent.rglob("*")
                                 if p.is_file())]
        for name, f in files + [(f.name, f) for f in self.includes]:
            h.update(name.encode())
            h.update(b"\0")
            h.update(f.read_bytes())
        return h.hexdigest()[:16]

    def path(self) -> Path:
        """The built library's file (named by :meth:`digest`); its build log
        lies beside it with the suffix ``.log``."""
        return self.build_dir / f"lib{self.source.stem}-{self.digest()}.so"

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            so = self.path()
            if not (so.exists() and so.with_suffix(".log").exists()):
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
                self.seconds = time.perf_counter() - t0
                self.log = proc.stdout + proc.stderr
                # the log first, so that a library never lies without it;
                # atomic: concurrent builders never clash
                tmp.with_suffix(".log").write_text(self.log)
                os.replace(tmp.with_suffix(".log"), so.with_suffix(".log"))
                os.replace(tmp, so)
            else:
                self.log = so.with_suffix(".log").read_text()
            lib = ctypes.CDLL(str(so))
            self.bind(lib)
            self._lib = lib
            return lib
