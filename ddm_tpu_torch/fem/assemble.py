"""Batched FEM assembly in torch: the scalar Q1 diffusion form and
vector-valued Q1 linear elasticity.

Counterpart of ``ddm_tpu/fem/assemble.py`` (reference: PDELab's
ConvectionDiffusionFEM via examples/generic_ddm_problem.hh).  All element
matrices are computed as one batched op over (elements, quadrature points),
then summed into the global ELL matrix through the host-built assembly plan
(core/sparse.py:EllPattern).

    a(u,v) = ∫ α ∇u·∇v ,   rhs ∫ f v

and (reference: dune-pdelab LinearElasticity, examples/linearelasticity.cc)

    a(u,v) = ∫ 2 μ ε(u):ε(v) + λ (div u)(div v) ,   rhs ∫ f·v

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


def assemble_linear_elasticity(quad: ElementQuadrature, xe: torch.Tensor,
                               lame_lambda_fn, lame_mu_fn, f_fn=None):
    """Batched element matrices/vectors of linear elasticity (vector Q1).

    Dof order within the element: node-major, component-minor, dof (i, c)
    -> i * d + c.  ``f_fn`` maps (..., d) points to (..., d) loads (None:
    zero load).  Returns (Ke (n_e, nd*d, nd*d), fe (n_e, nd*d))."""
    xq, grads, jxw = element_geometry(quad, xe)
    f = None if f_fn is None else f_fn(xq)
    return _elasticity_terms(quad, grads, jxw, lame_lambda_fn(xq),
                             lame_mu_fn(xq), f)


def _elasticity_terms(quad, grads, jxw, lam, mu, f):
    """Einsum stages of the elasticity assembly on per-quadrature-point
    coefficient values lam, mu (n_e, q) and f (n_e, q, d) or None."""
    n_e, _, nd, d = grads.shape
    # for u = phi_j e_c, v = phi_i e_k:
    #   eps(u):eps(v) = 0.5 (delta_ck grad phi_i . grad phi_j
    #                        + d_k phi_j d_c phi_i)
    #   div u div v   = d_c phi_j d_k phi_i
    gg = torch.einsum("eqig,eqjg->eqij", grads, grads)
    eye = torch.eye(d, dtype=grads.dtype, device=grads.device)
    eps_term = 0.5 * (
        torch.einsum("ck,eqij->eqijck", eye, gg)
        + torch.einsum("eqjk,eqic->eqijck", grads, grads)
    )
    div_term = torch.einsum("eqjc,eqik->eqijck", grads, grads)
    Kfull = (torch.einsum("eq,eqijck->eijck", jxw * 2 * mu, eps_term)
             + torch.einsum("eq,eqijck->eijck", jxw * lam, div_term))
    # (i, j, c, k) -> rows (i*d + k), cols (j*d + c)
    Ke = Kfull.permute(0, 1, 4, 2, 3).reshape(n_e, nd * d, nd * d)
    if f is None:
        fe = Ke.new_zeros((n_e, nd * d))
    else:
        fe = torch.einsum("eq,qi,eqc->eic", jxw, quad.phi, f).reshape(
            n_e, nd * d)
    return Ke, fe


def element_dofs(elems: np.ndarray, n_comp: int = 1) -> np.ndarray:
    """Host: (n_e, nd*n_comp) global dof ids per element, node-major and
    component-minor (dof = node * n_comp + c)."""
    if n_comp == 1:
        return elems
    return (elems[:, :, None] * n_comp + np.arange(n_comp)).reshape(
        elems.shape[0], -1)


def element_coo_indices(elems: np.ndarray, n_comp: int = 1):
    """Host: (rows, cols) COO index arrays matching ``Ke.reshape(-1)`` of an
    (n_e, nd*n_comp, nd*n_comp) element-matrix batch."""
    dofs = element_dofs(elems, n_comp)
    nl = dofs.shape[1]
    rows = np.repeat(dofs, nl, axis=1).reshape(-1)
    cols = np.tile(dofs, (1, nl)).reshape(-1)
    return rows, cols
