"""Batched FEM assembly in torch: the scalar convection-diffusion form and
vector-valued linear elasticity.

Counterpart of ``ddm_tpu/fem/assemble.py`` (reference: PDELab's
ConvectionDiffusionFEM via examples/generic_ddm_problem.hh).  All element
matrices are computed as one batched op over (elements, quadrature points),
then summed into the global ELL matrix through the host-built assembly plan
(core/sparse.py:EllPattern).

    a(u,v) = ∫ α ∇u·∇v + (b·∇u) v + c u v ,   rhs ∫ f v

and (reference: dune-pdelab LinearElasticity, examples/linearelasticity.cc)

    a(u,v) = ∫ 2 μ ε(u):ε(v) + λ (div u)(div v) ,   rhs ∫ f·v

on P1 triangles and tetrahedra (degree-2 rules) and Q1 quadrilaterals and
hexahedra (tensor-product 2-point Gauss).  The P2 element types of the JAX
package (``tri2``, ``quad2``) are not ported.  The Jacobian is inverted by
``torch.linalg.inv``/``det`` where the JAX package uses closed forms; the
element matrices agree to 1e-13 relative.
"""

from __future__ import annotations

import numpy as np
import torch

_GPT = 1.0 / np.sqrt(3.0)
_DIM = {"tri": 2, "tet": 3, "quad": 2, "hex": 3}


def _quad_rule(elem_type: str):
    """Returns (points (q, d), weights (q,)) on the reference element."""
    if elem_type == "tri":
        # degree 2, 3 points, area 1/2
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        return pts, np.full(3, 1 / 6)
    if elem_type == "tet":
        a, b = 0.5854101966249685, 0.1381966011250105
        pts = np.array([[b, b, b], [a, b, b], [b, a, b], [b, b, a]])
        return pts, np.full(4, 1 / 24)
    if elem_type not in _DIM:
        raise ValueError(f"element type '{elem_type}' is not ported")
    d = _DIM[elem_type]
    g1 = np.array([0.5 - 0.5 * _GPT, 0.5 + 0.5 * _GPT])
    grids = np.meshgrid(*([g1] * d), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=-1)
    return pts, np.full(2**d, 0.5**d)


def _shape_funs(elem_type: str, pts: np.ndarray):
    """phi (q, nd) and dphi (q, nd, d) at reference points.  P1 simplices:
    barycentric (1 - sum x, x_0, ..., x_{d-1}); Q1: local nodes in
    lexicographic order (bit dd of the node index = its coordinate dd)."""
    q, d = pts.shape
    if elem_type in ("tri", "tet"):
        phi0 = 1 - pts[:, 0]
        for k in range(1, d):  # 1 - x - y [- z], left to right
            phi0 = phi0 - pts[:, k]
        phi = np.concatenate([phi0[:, None], pts], axis=1)
        grad = np.concatenate([-np.ones((1, d)), np.eye(d)], axis=0)
        return phi, np.broadcast_to(grad, (q, d + 1, d)).copy()
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
        phi, dphi = _shape_funs(elem_type, pts)

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64, device=device)

        self.weights = t(w)  # (q,)
        self.phi = t(phi)  # (q, nd)
        self.dphi = t(dphi)  # (q, nd, d)


def _two_sum(a, b):
    """(s, e) with s = fl(a + b) and s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """(p, e) with p = fl(a * b) and p + e == a * b exactly (Dekker's
    split; no fused operation needed, so every device gives the same)."""
    def split(x):
        c = 134217729.0 * x  # 2**27 + 1
        hi = c - (c - x)
        return hi, x - hi

    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a, b, c):
    """a * b + c rounded once, as a fused multiply-add: the exact product
    and sum, with the low part added rounded to odd (Boldo and Melquiond's
    emulation), then one rounding to nearest."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    s, e = _two_sum(tl, ul)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((e != 0) & even, torch.nextafter(s, away), s)
    return th + s


def element_geometry(quad: ElementQuadrature, xe: torch.Tensor):
    """Per-quadrature-point geometry of a batch of elements.

    xe: (n_e, nd, d) vertex coordinates.  Returns (xq (n_e, q, d) physical
    points, grads (n_e, q, nd, d) physical shape gradients, jxw (n_e, q)
    |det J| * weight)."""
    # x(q) = sum_i phi_i(q) x_i, summed left to right in separate ops: the
    # islands coefficient jumps exactly on some quadrature points, so the
    # last bit decides which side they land on.  This order reproduces the
    # JAX package's points bit for bit, on the CPU and on the card alike
    # (a matmul's blocking would not).  XLA's CPU dot adds the three
    # products of a triangle as a fused multiply-add chain and the four or
    # eight of the other elements one rounded add at a time: both kept.
    nd = xe.shape[1]
    xq = quad.phi[None, :, 0, None] * xe[:, None, 0, :]
    for i in range(1, nd):
        phi_i, x_i = quad.phi[None, :, i, None], xe[:, None, i, :]
        if nd == 3:
            xq = _fma(phi_i.expand_as(xq), x_i.expand_as(xq), xq)
        else:
            xq = xq + phi_i * x_i
    J = torch.einsum("qid,eig->eqgd", quad.dphi, xe)  # dx/dxi
    grads = torch.einsum("qid,eqdg->eqig", quad.dphi, torch.linalg.inv(J))
    jxw = torch.abs(torch.linalg.det(J)) * quad.weights[None, :]
    return xq, grads, jxw


def assemble_convection_diffusion(quad: ElementQuadrature, xe: torch.Tensor,
                                  alpha_fn, b_fn=None, c_fn=None, f_fn=None,
                                  convection_divergence_form: bool = False):
    """Batched element matrices/vectors of the convection-diffusion form.

    xe: (n_e, nd, d).  Coefficient callables map (..., d) points to (...)
    values, the convection field ``b_fn`` to (..., d); None drops a term.
    ``convection_divergence_form`` takes -(u, b.grad v) in place of
    (b.grad u, v), the integrated-by-parts form that upwind DG face fluxes
    need (div b = 0, as PDELab's ConvectionDiffusionDG assumes).
    Returns (Ke (n_e, nd, nd), fe (n_e, nd))."""
    xq, grads, jxw = element_geometry(quad, xe)
    coeffs = (None if fn is None else fn(xq)
              for fn in (alpha_fn, b_fn, c_fn, f_fn))
    return _cd_terms(quad, grads, jxw, *coeffs, convection_divergence_form)


def _cd_terms(quad, grads, jxw, alpha, b, c, f, convection_divergence_form):
    """Einsum stages of the convection-diffusion assembly on
    per-quadrature-point coefficient values (None = term absent)."""
    Ke = torch.einsum("eq,eqig,eqjg->eij", jxw * alpha, grads, grads)
    if b is not None:
        if convection_divergence_form:  # - u_j (b . grad v_i)
            Ke = Ke - torch.einsum("eq,eqd,eqid,qj->eij", jxw, b, grads,
                                   quad.phi)
        else:  # + (b . grad u_j) v_i
            Ke = Ke + torch.einsum("eq,qi,eqd,eqjd->eij", jxw, quad.phi, b,
                                   grads)
    if c is not None:
        Ke = Ke + torch.einsum("eq,qi,qj->eij", jxw * c, quad.phi, quad.phi)
    if f is None:
        fe = Ke.new_zeros(Ke.shape[:2])
    else:
        fe = torch.einsum("eq,qi->ei", jxw * f, quad.phi)
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
