"""Batched FEM assembly in torch: the scalar Q1 diffusion form.

Counterpart of ``ddm_tpu/fem/assemble.py`` (reference: PDELab's
ConvectionDiffusionFEM via examples/generic_ddm_problem.hh).  All element
matrices are computed as one batched op over (elements, quadrature points),
then summed into the global ELL matrix through the host-built assembly plan
(core/sparse.py:EllPattern).

    a(u,v) = ∫ α ∇u·∇v ,   rhs ∫ f v

on quadrilaterals (2-D) or hexahedra (3-D), tensor-product 2-point Gauss.
"""

from __future__ import annotations

import numpy as np
import torch

_GPT = 1.0 / np.sqrt(3.0)
_DIM = {"quad": 2, "hex": 3}


def _quad_rule(elem_type: str):
    """Returns (points (q, d), weights (q,)) on the reference element."""
    if elem_type not in _DIM:
        raise ValueError(f"element type '{elem_type}' is not ported (Q1 only)")
    d = _DIM[elem_type]
    g1 = np.array([0.5 - 0.5 * _GPT, 0.5 + 0.5 * _GPT])
    grids = np.meshgrid(*([g1] * d), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=-1)
    return pts, np.full(2**d, 0.5**d)


def _shape_funs(pts: np.ndarray):
    """Q1 phi (q, nd) and dphi (q, nd, d) at reference points, local nodes
    in lexicographic order (bit dd of the node index = its coordinate dd)."""
    q, d = pts.shape
    nd = 2**d
    phi = np.ones((q, nd))
    dphi = np.ones((q, nd, d))
    for i in range(nd):
        for dd in range(d):
            bit = (i >> dd) & 1
            f = pts[:, dd] if bit else 1 - pts[:, dd]
            df = 1.0 if bit else -1.0
            phi[:, i] *= f
            for other in range(d):
                dphi[:, i, other] *= df if other == dd else f
    return phi, dphi


class ElementQuadrature:
    """Reference-element data for an element type, on ``device``."""

    def __init__(self, elem_type: str, device):
        self.elem_type = elem_type
        pts, w = _quad_rule(elem_type)
        phi, dphi = _shape_funs(pts)

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64, device=device)

        self.weights = t(w)  # (q,)
        self.phi = t(phi)  # (q, nd)
        self.dphi = t(dphi)  # (q, nd, d)


def element_geometry(quad: ElementQuadrature, xe: torch.Tensor):
    """Per-quadrature-point geometry of a batch of elements.

    xe: (n_e, nd, d) vertex coordinates.  Returns (xq (n_e, q, d) physical
    points, grads (n_e, q, nd, d) physical shape gradients, jxw (n_e, q)
    |det J| * weight)."""
    # x(q) = sum_i phi_i(q) x_i, summed left to right in separate ops: the
    # islands coefficient jumps exactly on some quadrature points, so the
    # last bit decides which side they land on.  This order reproduces the
    # JAX package's points bit for bit, on the CPU and on the card alike
    # (a matmul's blocking would not).
    xq = quad.phi[None, :, 0, None] * xe[:, None, 0, :]
    for i in range(1, xe.shape[1]):
        xq = xq + quad.phi[None, :, i, None] * xe[:, None, i, :]
    J = torch.einsum("qid,eig->eqgd", quad.dphi, xe)  # dx/dxi
    grads = torch.einsum("qid,eqdg->eqig", quad.dphi, torch.linalg.inv(J))
    jxw = torch.abs(torch.linalg.det(J)) * quad.weights[None, :]
    return xq, grads, jxw


def assemble_diffusion(quad: ElementQuadrature, xe: torch.Tensor, alpha_fn,
                       f_fn):
    """Batched element matrices/vectors of the diffusion form (the
    ``b = c = None`` case of ddm_tpu's assemble_convection_diffusion).

    xe: (n_e, nd, d).  Returns (Ke (n_e, nd, nd), fe (n_e, nd))."""
    xq, grads, jxw = element_geometry(quad, xe)
    Ke = torch.einsum("eq,eqig,eqjg->eij", jxw * alpha_fn(xq), grads, grads)
    fe = torch.einsum("eq,qi->ei", jxw * f_fn(xq), quad.phi)
    return Ke, fe


def element_coo_indices(elems: np.ndarray):
    """Host: (rows, cols) COO index arrays matching ``Ke.reshape(-1)`` of an
    (n_e, nd, nd) element-matrix batch."""
    n_e, nd = elems.shape
    rows = np.repeat(elems, nd, axis=1).reshape(-1)
    cols = np.tile(elems, (1, nd)).reshape(-1)
    return rows, cols
