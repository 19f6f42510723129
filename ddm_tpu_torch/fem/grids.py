"""Grids: structured tensor-product grids and the common grid container.

Replaces the reference's grid layer (dune-grid YaspGrid / UGGrid+GmshReader,
used via examples/ddm_utilities.hh:33-171 ``make_grid``).  A grid here is a
plain host-side container of node coordinates and element connectivity —
device code never sees the grid, only index maps and batched element arrays
derived from it.

Element types and local node orderings:

* ``tri``  — P1 triangles, nodes (v0, v1, v2)
* ``tet``  — P1 tetrahedra, nodes (v0..v3)
* ``quad`` — Q1 quadrilaterals, tensor-product (lexicographic) ordering:
             (x0y0, x1y0, x0y1, x1y1) — matching DUNE's reference cube
* ``hex``  — Q1 hexahedra, lexicographic (z fastest-varying last):
             (000,100,010,110,001,101,011,111)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

ELEM_NODES = {"tri": 3, "tet": 4, "quad": 4, "hex": 8}
ELEM_DIM = {"tri": 2, "tet": 3, "quad": 2, "hex": 3}

# local faces (for DG skeleton terms and boundary identification), as tuples of
# local node indices; orientation is irrelevant for our use.
ELEM_FACES = {
    "tri": ((0, 1), (1, 2), (2, 0)),
    "quad": ((0, 1), (1, 3), (3, 2), (2, 0)),
    "tet": ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)),
    "hex": (
        (0, 1, 2, 3),  # z=0
        (4, 5, 6, 7),  # z=1
        (0, 1, 4, 5),  # y=0
        (2, 3, 6, 7),  # y=1
        (0, 2, 4, 6),  # x=0
        (1, 3, 5, 7),  # x=1
    ),
}


@dataclass
class Grid:
    nodes: np.ndarray  # (n_nodes, dim) float64
    elems: np.ndarray  # (n_elems, nodes_per_elem) int64
    elem_type: str
    # structured-grid metadata (cells per axis); None for unstructured grids
    shape: tuple[int, ...] | None = None
    _boundary_nodes: np.ndarray | None = field(default=None, repr=False)

    @property
    def dim(self) -> int:
        return ELEM_DIM[self.elem_type]

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_elems(self) -> int:
        return self.elems.shape[0]

    def elem_centroids(self) -> np.ndarray:
        return self.nodes[self.elems].mean(axis=1)

    def boundary_nodes(self) -> np.ndarray:
        """Boolean mask of nodes on the domain boundary.

        A face is on the boundary iff it belongs to exactly one element.
        """
        if self._boundary_nodes is not None:
            return self._boundary_nodes
        faces = ELEM_FACES[self.elem_type]
        all_faces = np.concatenate(
            [np.sort(self.elems[:, list(f)], axis=1) for f in faces], axis=0
        )
        uniq, counts = np.unique(all_faces, axis=0, return_counts=True)
        bnodes = np.unique(uniq[counts == 1].ravel())
        mask = np.zeros(self.n_nodes, dtype=bool)
        mask[bnodes] = True
        self._boundary_nodes = mask
        return mask


def structured_grid(
    cells: tuple[int, ...],
    lower: tuple[float, ...] | None = None,
    upper: tuple[float, ...] | None = None,
    simplex: bool = False,
) -> Grid:
    """Tensor-product grid on a box (YaspGrid equivalent).

    ``cells`` gives the number of cells per axis (len 2 -> quads, 3 -> hexes).
    ``simplex=True`` splits each 2D cell into two triangles
    (StructuredGridFactory::createSimplexGrid equivalent, used by the
    reference's nonlinear example).
    """
    dim = len(cells)
    lower = lower or (0.0,) * dim
    upper = upper or (1.0,) * dim
    axes = [np.linspace(lower[d], upper[d], cells[d] + 1) for d in range(dim)]
    # node index (i0,i1[,i2]) -> flat id with axis 0 fastest
    mesh = np.meshgrid(*axes, indexing="ij")
    nodes = np.stack([m.ravel(order="F") for m in mesh], axis=-1)
    nshape = tuple(c + 1 for c in cells)

    def nid(*idx):
        f = 0
        stride = 1
        for d in range(dim):
            f = f + idx[d] * stride
            stride *= nshape[d]
        return f

    if dim == 2:
        nx, ny = cells
        i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        i, j = i.ravel(order="F"), j.ravel(order="F")
        elems = np.stack(
            [nid(i, j), nid(i + 1, j), nid(i, j + 1), nid(i + 1, j + 1)], axis=-1
        )
        et = "quad"
    elif dim == 3:
        nx, ny, nz = cells
        i, j, k = np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
        )
        i, j, k = i.ravel(order="F"), j.ravel(order="F"), k.ravel(order="F")
        elems = np.stack(
            [
                nid(i, j, k),
                nid(i + 1, j, k),
                nid(i, j + 1, k),
                nid(i + 1, j + 1, k),
                nid(i, j, k + 1),
                nid(i + 1, j, k + 1),
                nid(i, j + 1, k + 1),
                nid(i + 1, j + 1, k + 1),
            ],
            axis=-1,
        )
        et = "hex"
    else:
        raise ValueError("structured_grid supports dim 2 and 3")
    if simplex:
        q = elems.astype(np.int64)
        if dim == 2:
            tris = np.concatenate([q[:, [0, 1, 3]], q[:, [0, 3, 2]]], axis=0)
            return Grid(nodes=nodes, elems=tris, elem_type="tri", shape=None)
        # 3D: Kuhn triangulation — 6 tets per cube, all sharing the main
        # diagonal (corner 0 -> corner 7); conforming across cells.  This is
        # what StructuredGridFactory::createSimplexGrid produces (used by
        # the reference's 3D elasticity bar, linearelasticity.cc:42).
        from itertools import permutations

        tets = []
        for perm in permutations(range(3)):
            c = 0
            path = [0]
            for d in perm:
                c |= 1 << d
                path.append(c)
            tets.append(q[:, path])
        return Grid(
            nodes=nodes, elems=np.concatenate(tets, axis=0),
            elem_type="tet", shape=None,
        )
    return Grid(nodes=nodes, elems=elems.astype(np.int64), elem_type=et, shape=cells)


def refine(grid: Grid, times: int = 1) -> Grid:
    """Uniform refinement.

    Structured grids re-mesh at doubled resolution; unstructured simplex
    grids (tri/tet) use edge-midpoint (red) refinement — the equivalent of
    ``grid->globalRefine`` applied to GmshReader meshes in the reference
    (examples/ddm_utilities.hh:86-89).
    """
    if times == 0:
        return grid
    if grid.shape is not None:
        cells = tuple(c * (2**times) for c in grid.shape)
        lo = tuple(grid.nodes.min(axis=0))
        hi = tuple(grid.nodes.max(axis=0))
        return structured_grid(cells, lo, hi)
    if grid.elem_type not in ("tri", "tet"):
        raise NotImplementedError(
            f"unstructured refine supports tri/tet, not {grid.elem_type}"
        )
    for _ in range(times):
        grid = _refine_simplex(grid)
    return grid


def _refine_simplex(grid: Grid) -> Grid:
    """One round of red (edge-midpoint) refinement of a tri/tet mesh."""
    elems = grid.elems
    nodes = grid.nodes
    n_nodes = nodes.shape[0]
    if grid.elem_type == "tri":
        pairs = ((0, 1), (1, 2), (0, 2))
    else:
        pairs = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
    # unique edge midpoints
    edges = np.stack(
        [np.sort(elems[:, list(p)], axis=1) for p in pairs], axis=1
    )  # (n_e, n_pairs, 2)
    flat = edges.reshape(-1, 2)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    mid_ids = (n_nodes + inv).reshape(elems.shape[0], len(pairs))
    new_nodes = np.concatenate(
        [nodes, 0.5 * (nodes[uniq[:, 0]] + nodes[uniq[:, 1]])], axis=0
    )
    v = elems
    m = mid_ids
    if grid.elem_type == "tri":
        # m01=m[:,0], m12=m[:,1], m02=m[:,2]
        children = [
            np.stack([v[:, 0], m[:, 0], m[:, 2]], 1),
            np.stack([m[:, 0], v[:, 1], m[:, 1]], 1),
            np.stack([m[:, 2], m[:, 1], v[:, 2]], 1),
            np.stack([m[:, 0], m[:, 1], m[:, 2]], 1),
        ]
    else:
        # midpoints: m01,m02,m03,m12,m13,m23 — 4 corner tets + 4 from the
        # inner octahedron split along the (m01, m23) diagonal (Bey's rule)
        m01, m02, m03, m12, m13, m23 = (m[:, i] for i in range(6))
        children = [
            np.stack([v[:, 0], m01, m02, m03], 1),
            np.stack([v[:, 1], m01, m12, m13], 1),
            np.stack([v[:, 2], m02, m12, m23], 1),
            np.stack([v[:, 3], m03, m13, m23], 1),
            np.stack([m01, m02, m03, m13], 1),
            np.stack([m01, m02, m12, m13], 1),
            np.stack([m02, m03, m13, m23], 1),
            np.stack([m02, m12, m13, m23], 1),
        ]
    new_elems = np.concatenate(children, axis=0).astype(np.int64)
    return Grid(nodes=new_nodes, elems=new_elems, elem_type=grid.elem_type)
