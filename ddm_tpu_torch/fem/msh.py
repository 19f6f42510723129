"""Gmsh ``.msh`` v2.2 ASCII parser (a copy of ``ddm_tpu/fem/msh.py``).

Replaces dune-grid's GmshReader for the meshes shipped with the reference
(its data/{unitsquare,unitcube,bar,lshape}.msh, all format 2.2).
Only the highest-dimensional element block is kept; unused nodes are dropped
and the connectivity renumbered.
"""

from __future__ import annotations

import numpy as np

from .grids import Grid

# gmsh elm-type -> (our type, #nodes)
_GMSH_TYPES = {2: ("tri", 3), 3: ("quad", 4), 4: ("tet", 4), 5: ("hex", 8)}


def read_msh(path: str) -> Grid:
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0
    nodes = None
    elems_by_type: dict[str, list[list[int]]] = {}
    while i < len(lines):
        line = lines[i].strip()
        if line == "$MeshFormat":
            version = lines[i + 1].split()[0]
            if not version.startswith("2."):
                raise NotImplementedError(f"gmsh format {version}; only 2.x supported")
            i += 3
        elif line == "$Nodes":
            n = int(lines[i + 1])
            ids = np.empty(n, dtype=np.int64)
            xyz = np.empty((n, 3), dtype=np.float64)
            for k in range(n):
                parts = lines[i + 2 + k].split()
                ids[k] = int(parts[0])
                xyz[k] = [float(parts[1]), float(parts[2]), float(parts[3])]
            # gmsh ids are usually 1..n contiguous; build a remap to be safe
            remap = np.full(ids.max() + 1, -1, dtype=np.int64)
            remap[ids] = np.arange(n)
            nodes = xyz
            i += n + 3
        elif line == "$Elements":
            n = int(lines[i + 1])
            for k in range(n):
                parts = lines[i + 2 + k].split()
                etype = int(parts[1])
                if etype not in _GMSH_TYPES:
                    continue
                name, nn = _GMSH_TYPES[etype]
                ntags = int(parts[2])
                conn = [int(p) for p in parts[3 + ntags : 3 + ntags + nn]]
                elems_by_type.setdefault(name, []).append(conn)
            i += n + 3
        else:
            i += 1
    if nodes is None or not elems_by_type:
        raise ValueError(f"no nodes/elements found in {path}")

    # keep the highest-dimensional element type present
    order = ["hex", "tet", "quad", "tri"]
    etype = next(t for t in order if t in elems_by_type)
    conn = remap[np.asarray(elems_by_type[etype], dtype=np.int64)]

    # drop unused nodes, renumber
    used = np.unique(conn)
    node_map = np.full(nodes.shape[0], -1, dtype=np.int64)
    node_map[used] = np.arange(used.size)
    conn = node_map[conn]
    coords = nodes[used]

    # drop the z column for 2d meshes
    if etype in ("tri", "quad") and np.allclose(coords[:, 2], coords[0, 2]):
        coords = coords[:, :2]

    # gmsh quad/hex ordering -> our lexicographic ordering
    if etype == "quad":
        conn = conn[:, [0, 1, 3, 2]]
    elif etype == "hex":
        conn = conn[:, [0, 1, 3, 2, 4, 5, 7, 6]]

    return Grid(nodes=np.ascontiguousarray(coords), elems=conn, elem_type=etype)
