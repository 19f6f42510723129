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

on P1 triangles and tetrahedra (degree-2 rules), Q1 quadrilaterals and
hexahedra (tensor-product 2-point Gauss), P2 triangles (``tri2``, the
degree-4 Dunavant 6-point rule) and Q2 quadrilaterals (``quad2``, 3x3
Gauss), whose extra dofs ``fem/highorder.py`` numbers.  Every stage is
formed as the JAX package forms it (the closed-form Jacobian inverse, each
contraction as staged products summed in XLA's CPU order, ``_SUM_TREES``),
so on the CPU the two packages give the same bits; the card runs the same
staged code in the same fixed order.
"""

from __future__ import annotations

import os

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
    if elem_type == "tri2":
        # degree 4 (Dunavant 6-point) for P2 stiffness and mass terms
        a1, a2 = 0.445948490915965, 0.091576213509771
        w1, w2 = 0.223381589678011, 0.109951743655322
        pts = np.array([
            [a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
            [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2],
        ])
        return pts, np.array([w1, w1, w1, w2, w2, w2]) * 0.5
    if elem_type == "quad2":
        # 3x3 Gauss on [0,1]^2, x slowest
        g = np.array([0.5 - 0.5 * np.sqrt(3 / 5), 0.5,
                      0.5 + 0.5 * np.sqrt(3 / 5)])
        wg = np.array([5 / 18, 8 / 18, 5 / 18])
        X, Y = np.meshgrid(g, g, indexing="ij")
        return np.stack([X.ravel(), Y.ravel()], -1), np.outer(wg, wg).ravel()
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
    if elem_type == "tri2":
        return _p2_tri_funs(pts)
    if elem_type == "quad2":
        return _q2_quad_funs(pts)
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


def _p2_tri_funs(pts: np.ndarray):
    """P2 triangle: vertices (v0, v1, v2), then edge midpoints (e01, e12,
    e20); products of the barycentric coordinates L."""
    x, y = pts[:, 0], pts[:, 1]
    L = [1 - x - y, x, y]
    dL = [np.array([-1.0, -1.0]), np.array([1.0, 0.0]), np.array([0.0, 1.0])]
    q = pts.shape[0]
    phi = np.zeros((q, 6))
    dphi = np.zeros((q, 6, 2))
    for i in range(3):
        phi[:, i] = L[i] * (2 * L[i] - 1)
        dphi[:, i] = (4 * L[i] - 1)[:, None] * dL[i][None, :]
    for k, (a, b) in enumerate([(0, 1), (1, 2), (2, 0)]):
        phi[:, 3 + k] = 4 * L[a] * L[b]
        dphi[:, 3 + k] = 4 * (L[a][:, None] * dL[b][None, :]
                              + L[b][:, None] * dL[a][None, :])
    return phi, dphi


def _q2_quad_funs(pts: np.ndarray):
    """Q2 quadrilateral: 9 nodes at t in {0, 1/2, 1} per axis, tensor
    lexicographic with x fastest."""
    def n1d(t):
        return np.stack([(2 * t - 1) * (t - 1), 4 * t * (1 - t),
                         t * (2 * t - 1)], -1)

    def dn1d(t):
        return np.stack([4 * t - 3, 4 - 8 * t, 4 * t - 1], -1)

    nx, ny = n1d(pts[:, 0]), n1d(pts[:, 1])
    dx, dy = dn1d(pts[:, 0]), dn1d(pts[:, 1])
    q = pts.shape[0]
    phi = np.zeros((q, 9))
    dphi = np.zeros((q, 9, 2))
    for j in range(3):
        for i in range(3):
            k = j * 3 + i
            phi[:, k] = nx[:, i] * ny[:, j]
            dphi[:, k, 0] = dx[:, i] * ny[:, j]
            dphi[:, k, 1] = nx[:, i] * dy[:, j]
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


def _strided(k: int, s: int = 1, n: int = 0):
    """The summation tree of ``k`` terms that takes the first ``n`` as
    ``s`` interleaved running sums (term j into sum j mod s), adds those
    pairwise ((s0 + s1) + (s2 + s3)), then the other terms one at a time.
    ``_strided(k)`` is the plain left-to-right sum."""
    if n == 0:
        return tuple(range(k))
    parts = [tuple(range(j, n, s)) for j in range(s)]
    while len(parts) > 1:
        parts = [(parts[i], parts[i + 1]) for i in range(0, len(parts), 2)]
    return (parts[0],) + tuple(range(n, k))


def _tree_sum(tree, factors, fused: bool = False):
    """sum_k a_k * b_k over the leaves k of ``tree`` with ``(a_k, b_k) =
    factors(k)``, added in the tree's order: a tuple adds its members left
    to right, a leaf is one product.  With ``fused`` every leaf added to a
    partial sum is added as one fused multiply-add, torch's ``addcmul``
    (one on the CPU, held to the JAX package's bits by
    tests/test_torch_assembly_bitwise.py, and on the card,
    tests/test_torch_kernels.py::test_cuda_addcmul_is_a_fused_multiply_add).
    Plain recursion, not a nested function that calls itself: that would
    be a reference cycle holding ``factors``, and with it the operands,
    until the garbage collector runs."""
    if isinstance(tree, int):
        a, b = factors(tree)
        return a * b
    acc = _tree_sum(tree[0], factors, fused)
    for u in tree[1:]:
        if fused and isinstance(u, int):
            acc = torch.addcmul(acc, *factors(u))
        else:
            acc = acc + _tree_sum(u, factors, fused)
    return acc


#: The order in which XLA's CPU backend sums each contraction of the JAX
#: package's assembly (``jnp.einsum`` lowers each to a dot whose loop
#: order and vectorization depend on its shape), by element type: (tree,
#: fused) per stage, in the :func:`_tree_sum` notation.  Leaves: ``J``
#: node i; ``grads`` and ``gg`` axis d; ``Ke`` (axis g, point q) as
#: g * n_q + q; ``c``, ``fe``, ``b_q``, ``Kel``, ``fel`` point q; ``b_d``
#: axis d.  A third member maps the output rows or columns that XLA takes
#: as a remainder of its tiling to their own tree.  Read from XLA's
#: results by ``tests/xla_sum_trees.py`` (all terms 1 but a +M, -M pair,
#: whose sum counts the terms outside their lowest common subtree).
_SUM_TREES = {
    "quad": dict(J=(_strided(4), False), grads=(_strided(2), True),
                 Ke=(_strided(8, 2, 8), False), c=(_strided(4), False),
                 fe=(_strided(4), False), b_d=(_strided(2), True),
                 b_q=(_strided(4), False), gg=(_strided(2), True),
                 Kel=(_strided(4), True), fel=(_strided(4), False)),
    "tri": dict(J=(_strided(3), True), grads=(_strided(2), True),
                Ke=(_strided(6), True), c=(_strided(3), True),
                fe=(_strided(3), False, {2: (_strided(3), True)}),
                b_d=(_strided(2), True),
                b_q=(_strided(3), False, {2: (_strided(3), True)}),
                gg=(_strided(2), True), Kel=(_strided(3), True),
                fel=(_strided(3), False, {2: (_strided(3), True)})),
    "hex": dict(J=(_strided(8), False), grads=(_strided(3), True),
                Ke=(_strided(24), False), c=(_strided(8), False),
                fe=(_strided(8), False), b_d=(_strided(3), True),
                b_q=(_strided(8), False), gg=(_strided(3), True),
                Kel=(_strided(8), True), fel=(_strided(8), False)),
    "tet": dict(J=(_strided(4), False), grads=(_strided(3), True),
                Ke=(_strided(12, 2, 8), False), c=(_strided(4), False),
                fe=(_strided(4), False), b_d=(_strided(3), True),
                b_q=(_strided(4), False), gg=(_strided(3), True),
                Kel=(_strided(4), True), fel=(_strided(4), False)),
    "tri2": dict(J=(_strided(6), False), grads=(_strided(2), True),
                 Ke=(_strided(12, 2, 8), False,
                     {slice(4, 6): (_strided(12), False)}),
                 c=(_strided(6), False), fe=(_strided(6), False),
                 b_d=(_strided(2), True),
                 b_q=(_strided(6), False)),
    "quad2": dict(J=(_strided(9), False, {8: (_strided(9, 2, 8), False)}),
                  grads=(_strided(2), True),
                  Ke=(_strided(18), False,
                      {(slice(0, 8), 8): (_strided(18, 4, 16), False)}),
                  c=(_strided(9), False),
                  fe=(_strided(9), False, {8: (_strided(9, 4, 8), False)}),
                  b_d=(_strided(2), True),
                  b_q=(_strided(9), False, {8: (_strided(9, 4, 8), False)})),
}


def _contract(quad, stage: str, factors, axis: int = 1):
    """The contraction ``stage`` of ``quad``'s assembly, summed in XLA's
    order (:data:`_SUM_TREES`).  A remainder entry keyed by an index or
    slice of output ``axis``, or by a (rows, columns) pair of the two
    output axes from ``axis`` on, is summed in its own order there."""
    tree, fused, *rest = _SUM_TREES[quad.elem_type][stage]
    out = _tree_sum(tree, factors, fused)
    for where, (t, f) in (rest[0].items() if rest else ()):
        idx = (slice(None),) * axis + (where if isinstance(where, tuple)
                                       else (where,))
        out[idx] = _tree_sum(
            t, lambda j: [torch.broadcast_to(x, out.shape)[idx]
                          for x in factors(j)], f)
    return out


def _det_inv_small(J: torch.Tensor, slab: bool = False):
    """Closed-form determinant and inverse of batched 2x2 / 3x3 Jacobians,
    operation for operation as the JAX package forms them (adjugate over
    determinant), so both give the same bits.  ``slab``: as in its
    compiled slab body, where LLVM contracts each a*b - c*d into
    fma(a, b, -(c*d)) and the determinant m00 c00 + m01 c01 + m02 c02
    into fma(m02, c02, fma(m00, c00, m01 c01))."""
    def cof(a, b, c, e):  # a*b - c*e
        return torch.addcmul(-(c * e), a, b) if slab else a * b - c * e

    d = J.shape[-1]
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = cof(a, e, b, c)
        inv = torch.stack([torch.stack([e, -b], -1),
                           torch.stack([-c, a], -1)], -2) / det[..., None, None]
        return det, inv
    m = J
    c00 = cof(m[..., 1, 1], m[..., 2, 2], m[..., 1, 2], m[..., 2, 1])
    c01 = cof(m[..., 1, 2], m[..., 2, 0], m[..., 1, 0], m[..., 2, 2])
    c02 = cof(m[..., 1, 0], m[..., 2, 1], m[..., 1, 1], m[..., 2, 0])
    if slab:
        det = torch.addcmul(torch.addcmul(m[..., 0, 1] * c01, m[..., 0, 0],
                                          c00), m[..., 0, 2], c02)
    else:
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    c10 = cof(m[..., 0, 2], m[..., 2, 1], m[..., 0, 1], m[..., 2, 2])
    c11 = cof(m[..., 0, 0], m[..., 2, 2], m[..., 0, 2], m[..., 2, 0])
    c12 = cof(m[..., 0, 1], m[..., 2, 0], m[..., 0, 0], m[..., 2, 1])
    c20 = cof(m[..., 0, 1], m[..., 1, 2], m[..., 0, 2], m[..., 1, 1])
    c21 = cof(m[..., 0, 2], m[..., 1, 0], m[..., 0, 0], m[..., 1, 2])
    c22 = cof(m[..., 0, 0], m[..., 1, 1], m[..., 0, 1], m[..., 1, 0])
    inv = torch.stack([torch.stack([c00, c10, c20], -1),
                       torch.stack([c01, c11, c21], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    return det, inv / det[..., None, None]


def element_geometry(quad: ElementQuadrature, xe: torch.Tensor):
    """Per-quadrature-point geometry of a batch of elements.

    xe: (n_e, nd, d) vertex coordinates.  Returns (xq (n_e, q, d) physical
    points, grads (n_e, q, nd, d) physical shape gradients, jxw (n_e, q)
    |det J| * weight), bit for bit as the JAX package on the CPU."""
    return (_points(quad, xe),) + _gradients(quad, xe)


def _points(quad: ElementQuadrature, xe: torch.Tensor) -> torch.Tensor:
    """The physical quadrature points (n_e, q, d) of a batch of elements."""
    # x(q) = sum_i phi_i(q) x_i, summed in separate ops: the islands
    # coefficient jumps exactly on some quadrature points, so the last bit
    # decides which side they land on.  These orders reproduce the JAX
    # package's points bit for bit, on the CPU and on the card alike (a
    # matmul's blocking would not).  XLA's CPU dot adds the three products
    # of a triangle as a fused multiply-add chain, and the four, six or
    # eight of the other elements one rounded add at a time, left to right.
    # With nine (Q2) it does so for the first eight points only; the ninth
    # it takes as a remainder row, over 4-column blocks of the flattened
    # (element, axis) index, as ((p0 + p4) + (p1 + p5)) + ((p2 + p6) +
    # (p3 + p7)) + p8, the columns past the last full block left to right
    # (checked bit for bit from 8^2 to 192^2 cells).
    nd = xe.shape[1]
    xq = quad.phi[None, :, 0, None] * xe[:, None, 0, :]
    for i in range(1, nd):
        phi_i, x_i = quad.phi[None, :, i, None], xe[:, None, i, :]
        if nd == 3:
            xq = torch.addcmul(xq, phi_i, x_i)
        else:
            xq = xq + phi_i * x_i
    if nd == 9:
        p = [(quad.phi[8, i] * xe[:, i, :]).reshape(-1) for i in range(9)]
        blocked = (((p[0] + p[4]) + (p[1] + p[5]))
                   + ((p[2] + p[6]) + (p[3] + p[7]))) + p[8]
        full = blocked.numel() // 4 * 4
        row = xq[:, 8].reshape(-1).clone()
        row[:full] = blocked[:full]
        xq[:, 8] = row.reshape(xq[:, 8].shape)
    return xq


def _gradients(quad: ElementQuadrature, xe: torch.Tensor, slab: bool = False):
    """(grads (n_e, q, nd, d), jxw (n_e, q)) of a batch of elements;
    ``slab``: as the JAX package's slab body forms them
    (:func:`_det_inv_small`)."""
    dphi = quad.dphi
    J = _contract(quad, "J", lambda i: (dphi[None, :, i, None, :],
                                        xe[:, None, i, :, None]))
    det, inv = _det_inv_small(J, slab)  # J[e, q] = dx/dxi
    grads = _contract(quad, "grads", lambda k: (dphi[None, :, :, k, None],
                                                inv[:, :, None, k, :]))
    jxw = torch.abs(det) * quad.weights[None, :]
    return grads, jxw


def _elem_chunk(quad: ElementQuadrature, xe: torch.Tensor,
                factor: int = 1) -> int | None:
    """Element-batch slab size, or None to assemble in one shot, by the JAX
    package's rule: slabs once the gradient entries n_e * q * nd * d
    (times ``factor``, nd * d for elasticity's (e, q, i, j, c, k) terms)
    pass twice the budget of 4M per slab.  ``DDM_ASSEMBLY_CHUNK`` sets
    the slab size (0 or a size >= n_e: one shot)."""
    env = os.environ.get("DDM_ASSEMBLY_CHUNK")
    if env is not None:
        c = int(env)
        return None if c <= 0 or c >= xe.shape[0] else c
    n_e, nd, d = xe.shape
    budget = 4 << 20  # gradient entries per slab (32 MB in f64)
    per = quad.phi.shape[0] * nd * d * factor
    if n_e * per <= 2 * budget:
        return None
    return max(1024, budget // per)


def _chunked_elements(body, args, chunk: int):
    """``body`` (a list of slab tensors -> a tuple of (n_slab, ...)
    tensors) over the element batch in slabs of ``chunk`` elements, the
    outputs written into one (n_e, ...) tensor each.  ``args`` are
    (n_e, ...) tensors or None (passed through).  As the JAX package's
    ``lax.map``, the last slab is padded by repeating the last element,
    whose results are sliced off."""
    n_e = next(a for a in args if a is not None).shape[0]
    k = -(-n_e // chunk)
    pad = k * chunk - n_e
    if pad:
        args = [None if a is None else
                torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])])
                for a in args]
    outs = None
    for s in range(k):
        part = body([None if a is None else a[s * chunk:(s + 1) * chunk]
                     for a in args])
        if outs is None:
            outs = [o.new_empty((k * chunk,) + o.shape[1:]) for o in part]
        for o, p in zip(outs, part):
            o[s * chunk:(s + 1) * chunk] = p
    return tuple(o[:n_e] for o in outs)


def assemble_convection_diffusion(quad: ElementQuadrature, xe: torch.Tensor,
                                  alpha_fn, b_fn=None, c_fn=None, f_fn=None,
                                  convection_divergence_form: bool = False):
    """Batched element matrices/vectors of the convection-diffusion form.

    xe: (n_e, nd, d).  Coefficient callables map (..., d) points to (...)
    values, the convection field ``b_fn`` to (..., d); None drops a term.
    ``convection_divergence_form`` takes -(u, b.grad v) in place of
    (b.grad u, v), the integrated-by-parts form that upwind DG face fluxes
    need (div b = 0, as PDELab's ConvectionDiffusionDG assumes).
    Large batches run in slabs (:func:`_elem_chunk`): the coefficients
    over the whole batch, the geometry and the element terms per slab.
    Returns (Ke (n_e, nd, nd), fe (n_e, nd))."""
    xq = _points(quad, xe)
    coeffs = [None if fn is None else fn(xq)
              for fn in (alpha_fn, b_fn, c_fn, f_fn)]

    chunk = _elem_chunk(quad, xe)
    if chunk is None:
        return _cd_terms(quad, *_gradients(quad, xe), *coeffs,
                         convection_divergence_form)
    return _chunked_elements(
        lambda s: _cd_terms(quad, *_gradients(quad, s[0], slab=True), *s[1:],
                            convection_divergence_form), [xe] + coeffs, chunk)


def _cd_terms(quad, grads, jxw, alpha, b, c, f, convection_divergence_form):
    """The convection-diffusion element terms on per-quadrature-point
    coefficient values (None = term absent), each contraction formed and
    summed as the JAX package's ``jnp.einsum`` is on XLA's CPU."""
    nq = grads.shape[1]
    phi = quad.phi
    # sum_{g, q} (jxw alpha)_q grad_i,g grad_j,g
    w = (jxw * alpha)[:, :, None, None] * grads
    Ke = _contract(quad, "Ke", lambda m: (
        w[:, m % nq, :, m // nq, None], grads[:, m % nq, None, :, m // nq]))
    if b is not None:
        jb = jxw[:, :, None] * b
        # (b . grad phi_j) at each point, then sum_q against phi_i
        bg = _contract(quad, "b_d", lambda k: (grads[..., k],
                                               jb[:, :, None, k]))
        if convection_divergence_form:  # - u_j (b . grad v_i)
            Ke = Ke - _contract(quad, "b_q", lambda q: (
                bg[:, q, :, None], phi[None, q, None, :]), axis=2)
        else:  # + (b . grad u_j) v_i
            Ke = Ke + _contract(quad, "b_q", lambda q: (
                bg[:, q, None, :], phi[None, q, :, None]))
    if c is not None:
        cw = jxw * c
        Ke = Ke + _contract(quad, "c", lambda q: (
            phi[q, None, :] * phi[q, :, None], cw[:, q, None, None]))
    if f is None:
        fe = Ke.new_zeros(Ke.shape[:2])
    else:
        fw = jxw * f
        fe = _contract(quad, "fe", lambda q: (fw[:, q, None],
                                              phi[None, q, :]))
    return Ke, fe


def assemble_linear_elasticity(quad: ElementQuadrature, xe: torch.Tensor,
                               lame_lambda_fn, lame_mu_fn, f_fn=None):
    """Batched element matrices/vectors of linear elasticity (vector Q1).

    Dof order within the element: node-major, component-minor, dof (i, c)
    -> i * d + c.  ``f_fn`` maps (..., d) points to (..., d) loads (None:
    zero load).  Large batches run in slabs, as in
    :func:`assemble_convection_diffusion`.  Returns (Ke (n_e, nd*d,
    nd*d), fe (n_e, nd*d))."""
    xq = _points(quad, xe)
    coeffs = [lame_lambda_fn(xq), lame_mu_fn(xq),
              None if f_fn is None else f_fn(xq)]
    chunk = _elem_chunk(quad, xe, factor=xe.shape[1] * xe.shape[2])
    if chunk is None:
        return _elasticity_terms(quad, *_gradients(quad, xe), *coeffs)
    return _chunked_elements(
        lambda s: _elasticity_terms(quad, *_gradients(quad, s[0], slab=True),
                                    *s[1:], slab=True), [xe] + coeffs, chunk)


def _elasticity_terms(quad, grads, jxw, lam, mu, f, slab: bool = False):
    """The elasticity element terms on per-quadrature-point coefficient
    values lam, mu (n_e, q) and f (n_e, q, d) or None, formed and summed as
    the JAX package's ``jnp.einsum`` stages are on XLA's CPU.  ``slab``:
    as its ``lax.map`` body, one compiled program in which XLA fuses the
    sum of the strain term's two products into a fused multiply-add."""
    n_e, nq, nd, d = grads.shape
    # for u = phi_j e_c, v = phi_i e_k:
    #   eps(u):eps(v) = 0.5 (delta_ck grad phi_i . grad phi_j
    #                        + d_k phi_j d_c phi_i)
    #   div u div v   = d_c phi_j d_k phi_i
    # axes of the (e, q, i, j, c, k) terms
    gg = _contract(quad, "gg", lambda g: (grads[:, :, :, None, g],
                                          grads[:, :, None, :, g]))
    eye = torch.eye(d, dtype=grads.dtype, device=grads.device)
    gi = grads[:, :, :, None, :, None]  # d_c phi_i
    gj = grads[:, :, None, :, None, :]  # d_k phi_j
    if slab:
        eps_term = 0.5 * torch.addcmul(gg[..., None, None] * eye, gi, gj)
    else:
        eps_term = 0.5 * (gg[..., None, None] * eye + gi * gj)
    div_term = grads[:, :, None, :, :, None] * grads[:, :, :, None, None, :]
    mu2, lamw = jxw * 2 * mu, jxw * lam
    Kfull = (_contract(quad, "Kel", lambda q: (
                 mu2[:, q, None, None, None, None], eps_term[:, q]))
             + _contract(quad, "Kel", lambda q: (
                 lamw[:, q, None, None, None, None], div_term[:, q])))
    # (i, j, c, k) -> rows (i*d + k), cols (j*d + c)
    Ke = Kfull.permute(0, 1, 4, 2, 3).reshape(n_e, nd * d, nd * d)
    if f is None:
        fe = Ke.new_zeros((n_e, nd * d))
    else:
        jf = jxw[:, :, None] * f
        fe = _contract(quad, "fel", lambda q: (
            jf[:, q, None, :], quad.phi[None, q, :, None])).reshape(
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
