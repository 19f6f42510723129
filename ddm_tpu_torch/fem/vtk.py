"""Minimal VTU (VTK XML unstructured grid) writer.

Replaces the reference's dune-grid VTK output (examples/poisson.cc:324-386:
solution, POU, subdomain rank, coarse basis vectors).  ASCII VTU, host-side
numpy — visualization is not a device concern.
"""

from __future__ import annotations

import numpy as np

from .grids import Grid

_VTK_TYPE = {"tri": 5, "quad": 9, "tet": 10, "hex": 12}
# VTK node orderings differ from our lexicographic quad/hex ordering
_REORDER = {"quad": [0, 1, 3, 2], "hex": [0, 1, 3, 2, 4, 5, 7, 6]}


def write_vtu(
    path: str,
    grid: Grid,
    point_data: dict[str, np.ndarray] | None = None,
    cell_data: dict[str, np.ndarray] | None = None,
) -> None:
    nodes = np.asarray(grid.nodes, dtype=np.float64)
    if nodes.shape[1] == 2:
        nodes = np.concatenate([nodes, np.zeros((nodes.shape[0], 1))], axis=1)
    elems = np.asarray(grid.elems)
    if grid.elem_type in _REORDER:
        elems = elems[:, _REORDER[grid.elem_type]]
    n_pts, n_cells = nodes.shape[0], elems.shape[0]
    vtk_type = _VTK_TYPE[grid.elem_type]

    def arr(a, fmt="%.10g"):
        return "\n".join(" ".join(fmt % v for v in np.atleast_1d(row))
                         for row in np.asarray(a))

    parts = []
    parts.append('<?xml version="1.0"?>')
    parts.append('<VTKFile type="UnstructuredGrid" version="0.1" '
                 'byte_order="LittleEndian">')
    parts.append("<UnstructuredGrid>")
    parts.append(f'<Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">')
    parts.append("<Points>")
    parts.append('<DataArray type="Float64" NumberOfComponents="3" '
                 'format="ascii">')
    parts.append(arr(nodes))
    parts.append("</DataArray></Points>")
    parts.append("<Cells>")
    parts.append('<DataArray type="Int64" Name="connectivity" format="ascii">')
    parts.append(arr(elems, "%d"))
    parts.append("</DataArray>")
    parts.append('<DataArray type="Int64" Name="offsets" format="ascii">')
    parts.append(arr((np.arange(1, n_cells + 1) * elems.shape[1]), "%d"))
    parts.append("</DataArray>")
    parts.append('<DataArray type="UInt8" Name="types" format="ascii">')
    parts.append(arr(np.full(n_cells, vtk_type), "%d"))
    parts.append("</DataArray></Cells>")

    if point_data:
        parts.append("<PointData>")
        for name, data in point_data.items():
            data = np.asarray(data)
            nc = 1 if data.ndim == 1 else data.shape[1]
            parts.append(f'<DataArray type="Float64" Name="{name}" '
                         f'NumberOfComponents="{nc}" format="ascii">')
            parts.append(arr(data))
            parts.append("</DataArray>")
        parts.append("</PointData>")
    if cell_data:
        parts.append("<CellData>")
        for name, data in cell_data.items():
            parts.append(f'<DataArray type="Float64" Name="{name}" '
                         'format="ascii">')
            parts.append(arr(np.asarray(data, dtype=np.float64)))
            parts.append("</DataArray>")
        parts.append("</CellData>")
    parts.append("</Piece></UnstructuredGrid></VTKFile>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
