"""Build hand-written CUDA kernels into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into ``build/ddm_tpu_torch/``
at the root of the checkout (listed in ``.gitignore``), then loaded with
``ctypes``.  The sources include no PyTorch header, so a build takes
seconds.  Nothing here runs at import time, and nothing falls back: a
missing toolkit or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ddm_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library path."""
    src = SRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {src.name}:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    return lib


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first call)."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
