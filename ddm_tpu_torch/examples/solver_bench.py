"""Batched direct-solver benchmark (reference: examples/gpu_solvers.cc:
20-140).

Counterpart of ``ddm_tpu/examples/solver_bench.py``: the batched dense
factorizations the port uses — Cholesky factors against the explicit
inverse, the inverse stored in f64 and in f32, and LU — on a batch of
subdomain-sized Poisson-like blocks, each timed for the factorization and
for one resolve, with the largest residual |A x - b|, beside scipy's
SuperLU on the host as the CPU reference.  Runs on the CUDA card (CUDA
event times) unless ``device="cpu"`` is passed:

    python -m ddm_tpu_torch.examples.solver_bench [-n 512] [-batch 16] [-resolves 50]
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from ..api import default_device
from ..config import ParamTree, apply_cli_overrides
from ..solvers.direct import factor_batched

# (label, factor_batched arguments); the JAX package's fourth row is QR,
# its TPU stand-in for LU, which the port maps to LU
MODES = [
    ("cholesky/factors", dict(solver_type="cholesky", mode="factors")),
    ("cholesky/inverse", dict(solver_type="cholesky", mode="inverse")),
    ("cholesky/inverse-f32", dict(solver_type="cholesky", mode="inverse",
                                  store_dtype=torch.float32)),
    ("lu/inverse", dict(solver_type="lu", mode="inverse")),
]


def _timed(fn, device):
    """(result, milliseconds) of one call of ``fn``: CUDA events on the
    card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU."""
    if device.type != "cuda":
        return "device cpu"
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return f"device {smi}"


def main(argv=None, device=None) -> list[dict]:
    """Time every mode of :data:`MODES` and scipy's SuperLU; prints one
    row each and returns them as dicts (``name``, ``factor_ms``,
    ``resolve_ms``, ``resid``: max |A x - b|, None for SuperLU)."""
    device = default_device() if device is None else torch.device(device)
    pt = ParamTree({"n": 512, "batch": 16, "resolves": 50})
    apply_cli_overrides(pt, sys.argv[1:] if argv is None else list(argv))
    n, batch, resolves = pt.get("n", 512), pt.get("batch", 16), pt.get("resolves", 50)

    # a batch of 2-D Poisson-like SPD blocks, as the JAX example builds it
    rng = np.random.default_rng(0)
    T = np.zeros((n, n))
    i = np.arange(n)
    T[i, i] = 4.0
    T[i[:-1], i[:-1] + 1] = -1.0
    T[i[:-1] + 1, i[:-1]] = -1.0
    A = np.broadcast_to(T, (batch, n, n)).copy()
    A += rng.uniform(0, 0.01, (batch, 1, 1)) * np.eye(n)
    b_np = rng.normal(size=(batch, n))
    At = torch.as_tensor(A, device=device)
    b = torch.as_tensor(b_np, device=device)

    print(f"batch={batch} n={n} resolves={resolves} {device_line(device)}")
    rows = []
    for name, kw in MODES:
        factor_batched(At, **kw)  # warm-up: libraries, workspaces
        f, t_factor = _timed(lambda kw=kw: factor_batched(At, **kw), device)
        f.solve(b)

        def resolve_loop(f=f):
            r = b
            for _ in range(resolves):
                r = f.solve(r / torch.linalg.norm(r))
            return r

        _, t_loop = _timed(resolve_loop, device)
        x = f.solve(b)
        resid = float((At @ x[..., None])[..., 0].sub(b).abs().max())
        rows.append(dict(name=name, factor_ms=t_factor,
                         resolve_ms=t_loop / resolves, resid=resid))
        print(f"{name:>22}: factor {t_factor:8.2f} ms   resolve "
              f"{t_loop / resolves:8.3f} ms   resid {resid:.2e}")

    # CPU reference: scipy SuperLU on the sparse equivalent, sequential
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    t0 = time.perf_counter()
    lus = [spla.splu(sps.csc_matrix(A[k])) for k in range(batch)]
    t_factor = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(resolves):
        for k in range(batch):
            lus[k].solve(b_np[k])
    t_solve = (time.perf_counter() - t0) * 1e3 / resolves
    rows.append(dict(name="scipy SuperLU (seq)", factor_ms=t_factor,
                     resolve_ms=t_solve, resid=None))
    print(f"{'scipy SuperLU (seq)':>22}: factor {t_factor:8.2f} ms   "
          f"resolve {t_solve:8.3f} ms")
    return rows


if __name__ == "__main__":
    main()
