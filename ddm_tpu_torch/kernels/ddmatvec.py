"""Double-single batched matvec y = (hi + lo) @ d: the CUDA kernel and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``ddm_tpu/kernels/ddmatvec.py:dd_matvec_pallas``
and sits where the TPU package calls ``ddm_tpu/solvers/direct.py:dd_matvec``:
the apply of the double-single subdomain inverse (``BatchedInverseDD``,
three calls per Schwarz apply with the default two refinement steps).

* :func:`dd_matvec_reference` — the plain version, the TPU package's formula:
  three f32 products combined in f64 (TF32 off).
* :func:`dd_matvec_cuda` — the hand-written kernel ``csrc/dd_matvec.cu``:
  one read of hi and lo, f64 accumulation.  It is bound by the 8 bytes read
  per matrix entry (1.47 GB per call at the main path's (256, 848, 848));
  see the source for the design.
* :func:`dd_matvec` — the dispatcher: CPU tensors take the plain version,
  CUDA tensors the kernel; anything else raises.  There is no fallback from
  the kernel to the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch


@contextlib.contextmanager
def _tf32_off():
    """Full-precision f32 matmuls for the duration (restores the setting)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dd_matvec_reference(hi: torch.Tensor, lo: torch.Tensor,
                        d: torch.Tensor) -> torch.Tensor:
    """y = (hi+lo) @ d as three f32 matvecs combined in f64 — the formula
    of ``ddm_tpu/solvers/direct.py:dd_matvec``.  d: (n_sub, q) f64 with
    q <= P; reads the leading q x q block."""
    q = d.shape[1]
    if q != hi.shape[-1]:
        hi, lo = hi[:, :q, :q], lo[:, :q, :q]
    dh = d.to(torch.float32)
    dl = (d - dh.to(torch.float64)).to(torch.float32)
    eq = "spq,sq->sp"
    with _tf32_off():
        y0 = torch.einsum(eq, hi, dh)
        y1 = torch.einsum(eq, lo, dh) + torch.einsum(eq, hi, dl)
    return y0.to(torch.float64) + y1.to(torch.float64)


def dd_matvec_cuda(hi: torch.Tensor, lo: torch.Tensor,
                   d: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/dd_matvec.cu`` on PyTorch's current stream.

    hi, lo: (n_sub, P, P) float32 contiguous CUDA; d: (n_sub, q) float64
    contiguous CUDA with q <= P.  Returns y (n_sub, q) float64.  Adds one to
    ``dd_matvec_cuda.launches`` per launch."""
    if not (hi.is_cuda and lo.is_cuda and d.is_cuda):
        raise ValueError("dd_matvec_cuda needs CUDA tensors")
    if not (hi.device == lo.device == d.device):
        raise ValueError("hi, lo and d must be on one device")
    if hi.dtype != torch.float32 or lo.dtype != torch.float32:
        raise TypeError("hi and lo must be float32")
    if d.dtype != torch.float64:
        raise TypeError("d must be float64")
    if hi.ndim != 3 or hi.shape[1] != hi.shape[2] or lo.shape != hi.shape:
        raise ValueError(f"hi, lo must be (n_sub, P, P), got {hi.shape}, {lo.shape}")
    n_sub, P, _ = hi.shape
    if d.ndim != 2 or d.shape[0] != n_sub or d.shape[1] > P:
        raise ValueError(f"d must be (n_sub, q <= {P}), got {tuple(d.shape)}")
    if not (hi.is_contiguous() and lo.is_contiguous() and d.is_contiguous()):
        raise ValueError("hi, lo and d must be contiguous")
    if n_sub > 65535:
        raise ValueError("at most 65535 subdomains per launch")
    q = d.shape[1]
    y = torch.empty((n_sub, q), dtype=torch.float64, device=d.device)
    fn = _launcher()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(hi.data_ptr(), lo.data_ptr(), d.data_ptr(), y.data_ptr(),
                 n_sub, P, q, stream)
    if err != 0:
        raise RuntimeError(f"dd_matvec launch failed: CUDA error {err}")
    dd_matvec_cuda.launches += 1
    return y


dd_matvec_cuda.launches = 0


def _launcher():
    from .build import load

    fn = load("dd_matvec").ddm_dd_matvec
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def dd_matvec(hi: torch.Tensor, lo: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """y = (hi + lo) @ d for one right-hand side per subdomain, d (n_sub, q).
    CPU tensors: :func:`dd_matvec_reference`; CUDA tensors:
    :func:`dd_matvec_cuda`."""
    if d.ndim != 2:
        raise NotImplementedError("multi-RHS dd_matvec is not ported")
    if d.is_cuda:
        return dd_matvec_cuda(hi, lo, d)
    if d.device.type == "cpu" and hi.device.type == "cpu":
        return dd_matvec_reference(hi, lo, d)
    raise ValueError(f"dd_matvec: unsupported device {d.device}")
