"""Discontinuous Galerkin: Q1 SIPG on structured quads, P1 SIPG on triangles.

Counterpart of ``ddm_tpu/fem/dg.py`` (reference: PDELab's
ConvectionDiffusionDG local operator with DGLegendreSpace degree 1,
examples/convectiondiffusiondg.cc:36-60).  The skeleton terms are assembled
as batched per-face-family blocks (all vertical faces at once, all
horizontal faces at once; on triangles all interior faces at once) instead
of an intersection loop.

Method: symmetric interior penalty (SIPG) with coefficient-weighted averages
(SWIP) and upwinded convection, weak Dirichlet (Nitsche) and outflow
boundaries:

  interior F:  -{a du/dn}_w [v] - {a dv/dn}_w [u] + gamma [u][v]
               + (b.n) u_upwind [v]
  Dirichlet F: -a du/dn v - a dv/dn (u-g) + gamma (u-g) v
               + (b.n)^+ u v + (b.n)^- g v   (g terms -> rhs)
  Outflow  F:  (b.n)^+ u v

with omega_-/+ = delta_+/-/(delta_- + delta_+), delta = n.A n per side
evaluated at element centers, gamma = sigma * harmonic(delta)/h_perp.  The
nodal basis per element is used (the reference's Legendre modal basis spans
the same space).

Neumann stamps for GenEO (assemblewrapper.hh:271-367 skeleton-correction
analogue): volume+boundary blocks stamp on each element's dofs, each interior
face on its coupled dofs of both elements, so a face belongs to a
subdomain's Neumann matrix iff both its elements are inside.  Partial SIPG
face sums can be slightly indefinite: ``definite = False`` sends the GEVP to
its indefinite branch and the ring extension to LU.

Every sum of several contributions into one slot is a fixed-order sum: the
global matrix through the pattern's assembly plan, the boundary blocks of an
element one face after another in face order.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import scipy.sparse as sps
import torch

from ..core.sparse import EllPattern
from .assemble import ElementQuadrature, assemble_convection_diffusion
from .grids import ELEM_FACES, Grid
from .problems import Problem

_G = 1.0 / np.sqrt(3.0)
_QP = np.array([0.5 - 0.5 * _G, 0.5 + 0.5 * _G])  # 2-pt Gauss on [0,1]
_QW = np.array([0.5, 0.5])


def _trace(side: str, t: np.ndarray):
    """Q1 nodal traces/normal-derivative factors on a face of [0,1]^2.

    t: (q,) coordinates along the face.  Returns (T (q,4) values,
    Gn (q,4) outward-normal ref-derivatives; divide by h_perp for physical).
    Local node order: (x0y0, x1y0, x0y1, x1y1)."""
    z = np.zeros_like(t)
    o = 1.0 - t
    if side == "x1":  # face x=1, outward n=+x, coord t=y
        T = np.stack([z, o, z, t], -1)
        G = np.stack([-o, o, -t, t], -1)
    elif side == "x0":  # face x=0, n=-x
        T = np.stack([o, z, t, z], -1)
        G = -np.stack([-o, o, -t, t], -1)
    elif side == "y1":  # face y=1, n=+y, t=x
        T = np.stack([z, z, o, t], -1)
        G = np.stack([-o, -t, o, t], -1)
    elif side == "y0":  # face y=0, n=-y
        T = np.stack([o, t, z, z], -1)
        G = -np.stack([-o, -t, o, t], -1)
    else:
        raise ValueError(side)
    return T, G


def _rounds(idx: np.ndarray) -> list[np.ndarray]:
    """Host: positions of ``idx`` split into rounds of distinct values, the
    k-th occurrence of each value in round k, positions ascending.  Adding
    round after round sums each slot's contributions in position order with
    plain (non-accumulating) index writes."""
    order = np.argsort(idx, kind="stable")
    s = idx[order]
    start = np.r_[0, np.nonzero(s[1:] != s[:-1])[0] + 1]
    counts = np.diff(np.r_[start, s.size])
    rank = np.empty(idx.size, dtype=np.int64)
    rank[order] = np.arange(s.size) - np.repeat(start, counts)
    return [np.nonzero(rank == r)[0] for r in range(int(rank.max()) + 1)]


class _DGBase:
    """What both DG discretizations share: element-local dofs, weak boundary
    conditions, the pattern and its plan, and the COO assembly."""

    n_comp = 1
    definite = False

    def _setup(self, grid: Grid, problem: Problem, device, sigma: float,
               nl: int):
        self.grid = grid
        self.problem = problem
        self.sigma = sigma
        self.device = torch.device(device)
        self.nl = nl
        self.n_dofs = nl * grid.n_elems
        self.quad = ElementQuadrature(grid.elem_type, self.device)
        self.xe = self._t(grid.nodes[grid.elems])

    def _t(self, a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _i(self, a):
        return self._t(a, torch.int64)

    def dof_tuples(self) -> np.ndarray:
        return (self.nl * np.arange(self.grid.n_elems)[:, None]
                + np.arange(self.nl)).astype(np.int64)

    def _set_pattern(self, coupled: list[np.ndarray]):
        """Pattern and plan of the element blocks followed by one group of
        face blocks per array of coupled dof tuples in ``coupled``."""
        rows, cols = [], []
        for dofs in [self.dof_tuples()] + coupled:
            k = dofs.shape[1]
            rows.append(np.repeat(dofs, k, 1).ravel())
            cols.append(np.tile(dofs, (1, k)).ravel())
        self.pattern = EllPattern.from_coo(
            np.concatenate(rows), np.concatenate(cols), self.n_dofs)
        self._plan = self.pattern.assembly_plan(self.device)

    def adjacency(self) -> sps.csr_matrix:
        p = self.pattern
        return sps.csr_matrix(
            (np.ones(p.rows_csr.size), (p.rows_csr, p.cols_csr)),
            shape=(self.n_dofs, self.n_dofs),
        )

    @cached_property
    def dirichlet_mask(self) -> torch.Tensor:
        return torch.zeros(self.n_dofs, dtype=torch.bool, device=self.device)

    @cached_property
    def dirichlet_values(self) -> torch.Tensor:
        return torch.zeros(self.n_dofs, dtype=torch.float64, device=self.device)

    @cached_property
    def elem_centers(self) -> torch.Tensor:
        return self._t(self.grid.elem_centroids())

    def node_coords_dg(self) -> np.ndarray:
        """(n_dofs, 2) coordinates of each DG dof (element vertices)."""
        return self.grid.nodes[self.grid.elems].reshape(-1, 2)

    def element_matrices(self, problem: Problem | None = None):
        """Volume element blocks (convection in divergence form) and element
        loads (Ke, fe) of ``problem`` (default: the discretization's own),
        without the boundary and face terms that :meth:`neumann_stamps`
        adds."""
        p = problem or self.problem
        return assemble_convection_diffusion(
            self.quad, self.xe, p.alpha, p.b, p.c, p.f,
            convection_divergence_form=True)

    def _volume(self, p: Problem):
        """Volume element blocks and the load vector: each dof belongs to
        one element, so b = fe."""
        Ke, fe = self.element_matrices(p)
        return Ke, fe.reshape(-1).clone()

    def _add_boundary(self, Ke, b, eb, rounds, Kb, rb):
        """Ke[eb] += Kb, b[dofs of eb] += rb, face after face in order."""
        bv = b.view(-1, self.nl)
        for pos in rounds:
            e = eb[pos]
            Ke[e] = Ke[e] + Kb[pos]
            bv[e] = bv[e] + rb[pos]

    def assemble(self, problem: Problem | None = None):
        """Global (A, b): every block through the pattern's plan."""
        *blocks, b = self.assemble_parts(problem)
        coo = torch.cat([K.reshape(-1) for K in blocks])
        return self.pattern.assemble(coo, self._plan), b

    def constrained_system(self, problem: Problem | None = None):
        """Weak boundary conditions: nothing to eliminate, g = 0."""
        A, b = self.assemble(problem)
        return A, b, torch.zeros_like(b)

    def _stamp_problem(self, problem: Problem | None) -> Problem:
        p = problem or self.problem
        return p.symmetrized() if getattr(p, "symmetric", True) is False else p


class DGDiscretization(_DGBase):
    """Q1 SIPG convection-diffusion on a structured 2-D quad grid, on
    ``device``."""

    def __init__(self, grid: Grid, problem: Problem, device,
                 sigma: float = 4.0):
        if grid.shape is None or len(grid.shape) != 2:
            raise NotImplementedError(
                "DGDiscretization supports structured 2D quad grids")
        self._setup(grid, problem, device, sigma, 4)
        self.nx, self.ny = grid.shape
        lo = grid.nodes.min(axis=0)
        hi = grid.nodes.max(axis=0)
        self.hx = (hi[0] - lo[0]) / self.nx
        self.hy = (hi[1] - lo[1]) / self.ny
        self.lo = lo
        self._build_faces()
        d = self.dof_tuples()
        self._set_pattern([np.concatenate([d[em], d[ep]], axis=1)
                           for em, ep in self._families.values()])

    def _eid(self, i, j):
        return i + self.nx * j

    def _build_faces(self):
        nx, ny = self.nx, self.ny
        i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny), indexing="ij")
        vf = (self._eid(i, j).ravel(), self._eid(i + 1, j).ravel())
        i, j = np.meshgrid(np.arange(nx), np.arange(ny - 1), indexing="ij")
        hf = (self._eid(i, j).ravel(), self._eid(i, j + 1).ravel())
        self._families = {"v": vf, "h": hf}
        jj, ii = np.arange(ny), np.arange(nx)
        # boundary faces per side: each side's elements are distinct
        self.bf = {
            "x0": self._eid(np.zeros_like(jj), jj),
            "x1": self._eid(np.full_like(jj, nx - 1), jj),
            "y0": self._eid(ii, np.zeros_like(ii)),
            "y1": self._eid(ii, np.full_like(ii, ny - 1)),
        }

    def _face_points(self, family: str) -> torch.Tensor:
        """Physical quadrature points (nf, q, 2) of a face family."""
        if family == "v":
            xf = self.lo[0] + np.arange(1, self.nx) * self.hx
            yf = self.lo[1] + np.arange(self.ny) * self.hy
            X, Y = np.meshgrid(xf, yf, indexing="ij")
            pts = np.stack(
                [np.repeat(X.ravel()[:, None], 2, 1),
                 Y.ravel()[:, None] + _QP[None, :] * self.hy], -1)
        else:
            xf = self.lo[0] + np.arange(self.nx) * self.hx
            yf = self.lo[1] + np.arange(1, self.ny) * self.hy
            X, Y = np.meshgrid(xf, yf, indexing="ij")
            pts = np.stack(
                [X.ravel()[:, None] + _QP[None, :] * self.hx,
                 np.repeat(Y.ravel()[:, None], 2, 1)], -1)
        return self._t(pts)

    def _boundary_points(self, side: str) -> torch.Tensor:
        if side in ("x0", "x1"):
            x = self.lo[0] + (0.0 if side == "x0" else self.nx * self.hx)
            y0 = self.lo[1] + np.arange(self.ny) * self.hy
            pts = np.stack(
                [np.full((self.ny, 2), x), y0[:, None] + _QP[None, :] * self.hy],
                -1)
        else:
            y = self.lo[1] + (0.0 if side == "y0" else self.ny * self.hy)
            x0 = self.lo[0] + np.arange(self.nx) * self.hx
            pts = np.stack(
                [x0[:, None] + _QP[None, :] * self.hx, np.full((self.nx, 2), y)],
                -1)
        return self._t(pts)

    def _interior_face_blocks(self, p: Problem, family: str, alpha_c):
        """(nf, 8, 8) SIPG face blocks for one family."""
        em, ep = (self._i(a) for a in self._families[family])
        if family == "v":
            Tm, Gm = _trace("x1", _QP)
            Tp, Gp = _trace("x0", _QP)
            h_perp, area, normal = self.hx, self.hy, (1.0, 0.0)
        else:
            Tm, Gm = _trace("y1", _QP)
            Tp, Gp = _trace("y0", _QP)
            h_perp, area, normal = self.hy, self.hx, (0.0, 1.0)
        # fluxes use the FACE normal (minus -> plus); _trace returns the
        # element-outward derivative, which on the plus side is the negative
        Gp = -Gp
        nf = em.shape[0]
        w = self._t(_QW * area)  # (q,)
        Tm, Gm, Tp, Gp = (self._t(a) for a in
                          (Tm, Gm / h_perp, Tp, Gp / h_perp))
        dm = alpha_c[em][:, None]  # (nf, 1) delta_-
        dp = alpha_c[ep][:, None]
        om = dp / (dm + dp)
        op = dm / (dm + dp)
        gamma = self.sigma * (2 * dm * dp / (dm + dp)) / h_perp  # (nf, 1)

        Tm8 = Tm.expand(nf, 2, 4)
        Tp8 = Tp.expand(nf, 2, 4)
        z = torch.zeros_like(Tm8)
        J = torch.cat([Tm8, -Tp8], dim=2)  # (nf, q, 8)
        F = torch.cat([(om * dm)[:, :, None] * Gm[None],
                       (op * dp)[:, :, None] * Gp[None]], dim=2)
        if p.b is not None:
            bn = torch.einsum("fqd,d->fq", p.b(self._face_points(family)),
                              self._t(normal))
        else:
            bn = w.new_zeros((nf, 2))
        up = torch.where(bn[:, :, None] >= 0, torch.cat([Tm8, z], dim=2),
                         torch.cat([z, Tp8], dim=2))
        return (-torch.einsum("q,fqb,fqa->fab", w, F, J)
                - torch.einsum("q,fqa,fqb->fab", w, F, J)
                + gamma[:, :, None] * torch.einsum("q,fqa,fqb->fab", w, J, J)
                + torch.einsum("fq,q,fqb,fqa->fab", bn, w, up, J))

    def _boundary_blocks(self, p: Problem, side: str, alpha_c):
        """(nb, 4, 4) blocks + (nb, 4) rhs for one boundary side."""
        eb = self._i(self.bf[side])
        T, G = _trace(side, _QP)
        if side in ("x0", "x1"):
            h_perp, area = self.hx, self.hy
            normal = (-1.0, 0.0) if side == "x0" else (1.0, 0.0)
        else:
            h_perp, area = self.hy, self.hx
            normal = (0.0, -1.0) if side == "y0" else (0.0, 1.0)
        nb = eb.shape[0]
        w = self._t(_QW * area)
        T = self._t(T)
        G = self._t(G / h_perp)
        d = alpha_c[eb][:, None]  # (nb, 1)
        gamma = self.sigma * d / h_perp
        pts = self._boundary_points(side)  # (nb, q, 2)
        dirf = p.is_dirichlet(pts).to(torch.float64)
        gq = p.g(pts)
        if p.b is not None:
            bn = torch.einsum("fqd,d->fq", p.b(pts), self._t(normal))
        else:
            bn = w.new_zeros((nb, 2))
        bn_pos = torch.clamp(bn, min=0.0)
        bn_neg = torch.clamp(bn, max=0.0)
        K = (-torch.einsum("fq,q,qb,qa->fab", dirf * d, w, G, T)
             - torch.einsum("fq,q,qa,qb->fab", dirf * d, w, G, T)
             + torch.einsum("fq,q,qa,qb->fab", dirf * gamma, w, T, T)
             + torch.einsum("fq,q,qb,qa->fab", bn_pos, w, T, T))
        rhs = (-torch.einsum("fq,q,qa->fa", dirf * d * gq, w, G)
               + torch.einsum("fq,q,qa->fa", dirf * gamma * gq, w, T)
               - torch.einsum("fq,q,qa->fa", dirf * bn_neg * gq, w, T))
        return K, rhs

    def assemble_parts(self, problem: Problem | None = None):
        """(Ke (n_e, 4, 4) volume + boundary blocks, Kv (nfv, 8, 8), Kh
        (nfh, 8, 8) interior face blocks, b (n_dofs,))."""
        p = problem or self.problem
        alpha_c = p.alpha(self.elem_centers)
        Ke, b = self._volume(p)
        for side in ("x0", "x1", "y0", "y1"):
            Kb, rb = self._boundary_blocks(p, side, alpha_c)
            eb = self._i(self.bf[side])
            self._add_boundary(Ke, b, eb, [slice(None)], Kb, rb)
        Kv = self._interior_face_blocks(p, "v", alpha_c)
        Kh = self._interior_face_blocks(p, "h", alpha_c)
        return Ke, Kv, Kh, b

    def neumann_stamps(self, problem: Problem | None = None):
        """Stamp groups of ``problem`` (default: the discretization's own):
        volume + boundary blocks on element dofs, then the vertical and the
        horizontal face blocks on both elements' dofs; a nonsymmetric
        problem stamps its symmetrized operator."""
        Ke, Kv, Kh, _ = self.assemble_parts(self._stamp_problem(problem))
        d = self.dof_tuples()
        groups = [(d, Ke)]
        for (em, ep), K in zip(self._families.values(), (Kv, Kh)):
            groups.append((np.concatenate([d[em], d[ep]], axis=1), K))
        return groups


def _match_faces(elems: np.ndarray, elem_type: str):
    """Enumerate mesh faces from ELEM_FACES.

    Returns (interior, boundary):
      interior: (elem_m, lf_m, elem_p, lf_p) int arrays, one row set per
                shared face (minus = lower element id);
      boundary: (elem, lf) for faces owned by exactly one element."""
    faces = ELEM_FACES[elem_type]
    n_e = elems.shape[0]
    n_lf = len(faces)
    all_faces = np.stack(
        [np.sort(elems[:, list(f)], axis=1) for f in faces], axis=1
    ).reshape(n_e * n_lf, -1)  # row order: elem-major, local-face-minor
    owner_elem = np.repeat(np.arange(n_e), n_lf)
    owner_lf = np.tile(np.arange(n_lf), n_e)
    uniq, inverse, counts = np.unique(
        all_faces, axis=0, return_inverse=True, return_counts=True
    )
    order = np.argsort(inverse.reshape(-1), kind="stable")
    starts = np.zeros(uniq.shape[0], dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    if counts.max() > 2:
        raise ValueError("non-manifold mesh: a face shared by >2 elements")
    two = counts == 2
    first = order[starts[two]]
    second = order[starts[two] + 1]
    one = order[starts[~two]]
    interior = (owner_elem[first], owner_lf[first],
                owner_elem[second], owner_lf[second])
    boundary = (owner_elem[one], owner_lf[one])
    return interior, boundary


def _barycentric(xe: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """P1 trace values: barycentric coordinates of physical points.
    xe: (nf, 3, 2) triangle vertices; pts: (nf, q, 2).  Returns (nf, q, 3)."""
    v1 = xe[:, 1] - xe[:, 0]
    v2 = xe[:, 2] - xe[:, 0]
    det = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]
    r = pts - xe[:, None, 0]
    l1 = (r[..., 0] * v2[:, None, 1] - r[..., 1] * v2[:, None, 0]) / det[:, None]
    l2 = (v1[:, None, 0] * r[..., 1] - v1[:, None, 1] * r[..., 0]) / det[:, None]
    return torch.stack([1.0 - l1 - l2, l1, l2], dim=-1)


class SimplexDGDiscretization(_DGBase):
    """P1 SIPG convection-diffusion on unstructured triangle meshes, on
    ``device``: faces are enumerated from ``ELEM_FACES`` and all per-face
    geometry (normals, lengths, traces, constant P1 gradients) is batched
    over the whole face set.  Penalty length scale ``h_perp = min(vol-,
    vol+)/|F|`` (PDELab's face-measure convention)."""

    def __init__(self, grid: Grid, problem: Problem, device,
                 sigma: float = 4.0):
        if grid.elem_type != "tri":
            raise NotImplementedError(
                "SimplexDGDiscretization supports triangle meshes")
        self._setup(grid, problem, device, sigma, 3)
        self._build_faces()
        self._set_pattern([self._face_dofs()])

    def _build_faces(self):
        g = self.grid
        (em, lm, ep, lp), (eb, lb) = _match_faces(g.elems, "tri")
        self.f_elems = (em.astype(np.int64), ep.astype(np.int64))
        self.b_elems = eb.astype(np.int64)
        self._b_rounds = [self._i(r) for r in _rounds(self.b_elems)]

        faces = ELEM_FACES["tri"]
        X = g.nodes[g.elems]  # (n_e, 3, 2)
        v1 = X[:, 1] - X[:, 0]
        v2 = X[:, 2] - X[:, 0]
        self.vol = 0.5 * np.abs(v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0])
        cent = X.mean(axis=1)

        def face_geom(e, lf):
            """(pa, pb, normal (outward from e), length) for faces (e, lf)."""
            fa = np.array([faces[j][0] for j in lf])
            fb = np.array([faces[j][1] for j in lf])
            pa, pb = g.nodes[g.elems[e, fa]], g.nodes[g.elems[e, fb]]
            t = pb - pa
            L = np.linalg.norm(t, axis=1)
            nrm = np.stack([t[:, 1], -t[:, 0]], axis=1) / L[:, None]
            mid = 0.5 * (pa + pb)
            flip = np.einsum("fd,fd->f", nrm, mid - cent[e]) < 0
            nrm[flip] *= -1.0
            return pa, pb, nrm, L

        self.f_geom = face_geom(em, lm)
        self.b_geom = face_geom(eb, lb)

    def _face_dofs(self) -> np.ndarray:
        d = self.dof_tuples()
        em, ep = self.f_elems
        return np.concatenate([d[em], d[ep]], axis=1)  # (nf, 6)

    @cached_property
    def _grads(self) -> torch.Tensor:
        """(n_e, 3, 2) constant physical gradients of the P1 basis."""
        X = self.xe
        v1 = X[:, 1] - X[:, 0]
        v2 = X[:, 2] - X[:, 0]
        det = (v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0])[:, None]
        g1 = torch.stack([v2[:, 1], -v2[:, 0]], dim=1) / det
        g2 = torch.stack([-v1[:, 1], v1[:, 0]], dim=1) / det
        return torch.stack([-g1 - g2, g1, g2], dim=1)

    def _face_quadrature(self, geom):
        """(points (nf, q, 2), weights (nf, q), normals (nf, 2), lengths)."""
        pa, pb, nrm, L = (self._t(a) for a in geom)
        t = pb - pa
        pts = pa[:, None, :] + self._t(_QP)[None, :, None] * t[:, None, :]
        return pts, self._t(_QW)[None, :] * L[:, None], nrm, L

    def _interior_face_blocks(self, p: Problem, alpha_c):
        """(nf, 6, 6) SIPG blocks over all interior faces at once."""
        em, ep = (self._i(a) for a in self.f_elems)
        pts, w, nrm, L = self._face_quadrature(self.f_geom)
        Tm = _barycentric(self.xe[em], pts)  # (nf, q, 3)
        Tp = _barycentric(self.xe[ep], pts)
        # the face normal points out of the minus element (m -> p)
        Gm = torch.einsum("fid,fd->fi", self._grads[em], nrm)  # (nf, 3)
        Gp = torch.einsum("fid,fd->fi", self._grads[ep], nrm)
        dm = alpha_c[em][:, None]
        dp = alpha_c[ep][:, None]
        om = dp / (dm + dp)
        op = dm / (dm + dp)
        vol = self._t(self.vol)
        h_perp = torch.minimum(vol[em], vol[ep]) / L
        gamma = self.sigma * (2 * dm * dp / (dm + dp)) / h_perp[:, None]

        J = torch.cat([Tm, -Tp], dim=2)  # (nf, q, 6)
        F = torch.cat([((om * dm)[:, :, None] * Gm[:, None, :]).expand_as(Tm),
                       ((op * dp)[:, :, None] * Gp[:, None, :]).expand_as(Tp)],
                      dim=2)
        if p.b is not None:
            bn = torch.einsum("fqd,fd->fq", p.b(pts), nrm)
        else:
            bn = w.new_zeros(pts.shape[:2])
        z = torch.zeros_like(Tm)
        up = torch.where(bn[:, :, None] >= 0, torch.cat([Tm, z], dim=2),
                         torch.cat([z, Tp], dim=2))
        return (-torch.einsum("fq,fqb,fqa->fab", w, F, J)
                - torch.einsum("fq,fqa,fqb->fab", w, F, J)
                + gamma[:, :, None] * torch.einsum("fq,fqa,fqb->fab", w, J, J)
                + torch.einsum("fq,fq,fqb,fqa->fab", bn, w, up, J))

    def _boundary_blocks(self, p: Problem, alpha_c):
        """(nb, 3, 3) Nitsche/outflow blocks + (nb, 3) rhs."""
        eb = self._i(self.b_elems)
        pts, w, nrm, L = self._face_quadrature(self.b_geom)
        T = _barycentric(self.xe[eb], pts)  # (nb, q, 3)
        G = torch.einsum("fid,fd->fi", self._grads[eb], nrm)  # outward
        d = alpha_c[eb][:, None]  # (nb, 1)
        h_perp = self._t(self.vol)[eb] / L
        gamma = self.sigma * d / h_perp[:, None]
        dirf = p.is_dirichlet(pts).to(torch.float64)
        gq = p.g(pts)
        if p.b is not None:
            bn = torch.einsum("fqd,fd->fq", p.b(pts), nrm)
        else:
            bn = w.new_zeros(pts.shape[:2])
        bn_pos = torch.clamp(bn, min=0.0)
        bn_neg = torch.clamp(bn, max=0.0)
        K = (-torch.einsum("fq,fq,fb,fqa->fab", dirf * d, w, G, T)
             - torch.einsum("fq,fq,fa,fqb->fab", dirf * d, w, G, T)
             + torch.einsum("fq,fq,fqa,fqb->fab", dirf * gamma, w, T, T)
             + torch.einsum("fq,fq,fqb,fqa->fab", bn_pos, w, T, T))
        rhs = (-torch.einsum("fq,fq,fa->fa", dirf * d * gq, w, G)
               + torch.einsum("fq,fq,fqa->fa", dirf * gamma * gq, w, T)
               - torch.einsum("fq,fq,fqa->fa", dirf * bn_neg * gq, w, T))
        return K, rhs

    def assemble_parts(self, problem: Problem | None = None):
        """(Ke (n_e, 3, 3) volume + boundary blocks, Kf (nf, 6, 6) interior
        face blocks, b (n_dofs,))."""
        p = problem or self.problem
        alpha_c = p.alpha(self.elem_centers)
        Ke, b = self._volume(p)
        Kb, rb = self._boundary_blocks(p, alpha_c)
        self._add_boundary(Ke, b, self._i(self.b_elems), self._b_rounds,
                           Kb, rb)
        return Ke, self._interior_face_blocks(p, alpha_c), b

    def neumann_stamps(self, problem: Problem | None = None):
        """Stamp groups of ``problem`` (default: the discretization's own):
        volume + boundary blocks on element dofs, then the face blocks on
        both elements' dofs (symmetrized operator for a nonsymmetric
        problem)."""
        Ke, Kf, _ = self.assemble_parts(self._stamp_problem(problem))
        return [(self.dof_tuples(), Ke), (self._face_dofs(), Kf)]
