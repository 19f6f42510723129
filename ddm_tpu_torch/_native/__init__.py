"""Native (C++) host-topology kernels, loaded with ctypes.

Counterpart of ``ddm_tpu/_native/__init__.py``.  ``ddmcore.cpp`` is
compiled with g++ at first use into ``build/ddm_tpu_torch/libddmcore.so``
at the root of the checkout (the directory of the CUDA kernels,
``kernels/build.py:BUILD_DIR``, listed in ``.gitignore``), never beside
the source.  ``load()`` returns the library, or None when the build fails
(then it warns once); the scipy path of ``core/indexmaps.py`` gives the
same arrays, and ``build_topology(..., use_native=False)`` takes it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

from ..kernels.build import BUILD_DIR
from ..obs.logger import warn

SRC = Path(__file__).resolve().parent / "ddmcore.cpp"
LIB = BUILD_DIR / "libddmcore.so"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib: ctypes.CDLL | None = None
# why the library is unavailable, once a build or load has failed
error: str | None = None


def build(force: bool = False) -> Path:
    """Compile ``ddmcore.cpp`` unless an up-to-date library exists (always
    with ``force``); returns its path.  The compiler writes a temporary
    file that is renamed into place, so processes that build at once never
    load half a file.  Raises ``RuntimeError`` when g++ fails or is
    missing."""
    if (not force and LIB.exists()
            and LIB.stat().st_mtime >= SRC.stat().st_mtime):
        return LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not build {SRC.name}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, LIB)
    return LIB


def load() -> ctypes.CDLL | None:
    """The native library (built on first call), or None when it does not
    build; then ``error`` says why (a failed build is tried once per
    process)."""
    global _lib, error
    if _lib is not None or error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        error = str(e)
        warn("native ddmcore unavailable, the topology takes the scipy "
             "route: {}", error)
        return None
    lib.ddm_topology_compute.restype = ctypes.c_int64
    lib.ddm_topology_compute.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.ddm_topology_collect.restype = None
    lib.ddm_topology_collect.argtypes = [ctypes.c_void_p] * 4
    _lib = lib
    return _lib
