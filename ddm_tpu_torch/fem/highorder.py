"""Second-order (Pk/Qk, k=2) dof numbering on vertex meshes (a copy of
``ddm_tpu/fem/highorder.py``).

The reference uses degree-2 spaces in the nonlinear example (PDELab
PkLocalFiniteElementMap degree 2, examples/nonlinearpoisson.cc:104) and
supports Qk/Pk generally (problem_traits.hh:67-129).  Vertex meshes carry
only corners; this module enumerates the extra P2/Q2 dofs (edge midpoints,
Q2 face centers) on the host and produces the per-element dof tuples + dof
coordinates that the batched assembly and the DDM topology consume —
everything downstream is degree-agnostic.
"""

from __future__ import annotations

import numpy as np

from .grids import Grid


def _unique_edges(conn_pairs: np.ndarray, n_nodes: int):
    """conn_pairs: (n, 2) node pairs -> (edge ids (n,), unique pairs (m, 2))."""
    key = np.sort(conn_pairs, axis=1)
    flat = key[:, 0] * n_nodes + key[:, 1]
    uniq, inverse = np.unique(flat, return_inverse=True)
    pairs = np.stack([uniq // n_nodes, uniq % n_nodes], axis=1)
    return inverse, pairs


def p2_dofs(grid: Grid):
    """Returns (elem_dofs (n_e, nd2), dof_coords (n_dofs, d),
    dof_boundary_mask (n_dofs,), basis_name).

    tri -> 'tri2' (6 dofs: v0,v1,v2,e01,e12,e20)
    quad -> 'quad2' (9 dofs, tensor lexicographic)
    """
    elems = grid.elems
    nodes = grid.nodes
    n_nodes = grid.n_nodes
    vmask = grid.boundary_nodes()

    if grid.elem_type == "tri":
        e_pairs = np.concatenate(
            [elems[:, [0, 1]], elems[:, [1, 2]], elems[:, [2, 0]]], axis=0
        )
        edge_of, pairs = _unique_edges(e_pairs, n_nodes)
        n_e = elems.shape[0]
        e01 = edge_of[:n_e]
        e12 = edge_of[n_e : 2 * n_e]
        e20 = edge_of[2 * n_e :]
        elem_dofs = np.concatenate(
            [elems, n_nodes + np.stack([e01, e12, e20], axis=1)], axis=1
        )
        basis = "tri2"
    elif grid.elem_type == "quad":
        # lexicographic Q2 node positions: corners (0,2,6,8 of the 3x3
        # grid), edge midpoints (1,3,5,7), center (4)
        e_pairs = np.concatenate(
            [elems[:, [0, 1]], elems[:, [0, 2]], elems[:, [1, 3]],
             elems[:, [2, 3]]],
            axis=0,
        )
        edge_of, pairs = _unique_edges(e_pairs, n_nodes)
        n_e = elems.shape[0]
        e_bottom = edge_of[:n_e]
        e_left = edge_of[n_e : 2 * n_e]
        e_right = edge_of[2 * n_e : 3 * n_e]
        e_top = edge_of[3 * n_e :]
        n_edge = pairs.shape[0]
        center = n_nodes + n_edge + np.arange(n_e)
        elem_dofs = np.stack(
            [
                elems[:, 0], n_nodes + e_bottom, elems[:, 1],
                n_nodes + e_left, center, n_nodes + e_right,
                elems[:, 2], n_nodes + e_top, elems[:, 3],
            ],
            axis=1,
        )
        basis = "quad2"
    else:
        raise NotImplementedError(
            f"degree-2 dofs not implemented for {grid.elem_type}"
        )

    # a mid-edge dof is on the domain boundary iff its edge is a boundary
    # face (face used by exactly one element) — endpoint masks alone would
    # misclassify interior edges between two boundary vertices
    from .grids import ELEM_FACES

    faces = ELEM_FACES[grid.elem_type]
    all_faces = np.sort(
        np.concatenate([elems[:, list(f)] for f in faces], axis=0), axis=1
    )
    uniq_f, counts = np.unique(all_faces, axis=0, return_counts=True)
    bnd_face_keys = set(
        (int(a) * n_nodes + int(b)) for a, b in uniq_f[counts == 1]
    )
    edge_keys = pairs[:, 0] * n_nodes + pairs[:, 1]
    emask = np.array([int(k) in bnd_face_keys for k in edge_keys])

    mids = 0.5 * (nodes[pairs[:, 0]] + nodes[pairs[:, 1]])
    coords = [nodes, mids]
    bnd = [vmask, emask]
    if grid.elem_type == "quad":
        coords.append(grid.elem_centroids())
        bnd.append(np.zeros(n_e, dtype=bool))
    dof_coords = np.concatenate(coords, axis=0)
    dof_boundary = np.concatenate(bnd, axis=0)
    return elem_dofs.astype(np.int64), dof_coords, dof_boundary, basis
