"""Building and loading the port's CUDA kernels.

Each kernel is one ``.cu`` file with a plain C entry point, compiled with
``nvcc`` for ``sm_90a`` into a shared library in ``build/`` beside its
``csrc/`` directory (git-ignored), named by the source's hash so a stale
library is never loaded, and loaded with ``ctypes``.  A library is built at
first use; :func:`build` compiles several sources at once, one ``nvcc`` per
source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    return source.parent.parent / "build" / f"lib{source.stem}_{digest}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError("nvcc not found (no CUDA toolkit)")
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    return path


def build(sources, verbose: bool = False) -> list:
    """Compile every source whose library is missing, all ``nvcc`` processes
    at once; ``verbose`` rebuilds with ``-Xptxas -v`` and prints the
    compiler's report.  Returns the library paths."""
    sources = [Path(s) for s in sources]
    jobs = []
    try:
        for src in sources:
            out = library_path(src)
            if out.exists() and not verbose:
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, str(src)]
            jobs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{log}")
            if verbose:
                print(f"{src.name}:\n{log}", end="", flush=True)
            os.replace(tmp, out)  # atomic: concurrent builds agree
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return [library_path(s) for s in sources]


def load(source: Path, name: str, argtypes) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library; declares the C entry
    point ``name`` as returning an int (the CUDA error code)."""
    lib = ctypes.CDLL(str(build([source])[0]))
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib
