"""DDM setup orchestration: discretization -> partition -> topology.

Counterpart of ``ddm_tpu/core/setup.py`` (reference chain make_grid ->
loadBalance -> make_overlapping_communication, examples/poisson.cc:87-139),
all host-side.  The TPU package's canvas relayout of rectangular subdomains
is a TPU gather rule and is left out: the topology keeps the sorted
general layout of :func:`build_topology`.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from ..fem.discretize import Discretization
from .indexmaps import (
    DDMTopology,
    build_topology,
    dof_membership_from_elems,
    dof_owner_lowest,
    partition_rcb,
    partition_structured,
)


def partition_elements(
    disc: Discretization,
    n_sub: int | None = None,
    parts: tuple[int, ...] | None = None,
) -> np.ndarray:
    """Structured block partition when ``parts`` is given (YaspGrid PowerD
    equivalent), otherwise recursive coordinate bisection."""
    grid = disc.grid
    if parts is not None:
        if grid.shape is None:
            raise ValueError("parts= requires a structured grid")
        return partition_structured(grid.shape, parts)
    if n_sub is None:
        raise ValueError("pass n_sub or parts")
    return partition_rcb(grid.elem_centroids(), n_sub)


def setup_topology(
    disc: Discretization,
    overlap: int,
    n_sub: int | None = None,
    parts: tuple[int, ...] | None = None,
    elem_part: np.ndarray | None = None,
    pad_to: int = 8,
) -> tuple[DDMTopology, np.ndarray]:
    """Build the overlapping DDM topology.  Returns (topology, elem_part)."""
    if elem_part is None:
        elem_part = partition_elements(disc, n_sub=n_sub, parts=parts)
    topo = build_topology(*topology_inputs(disc, elem_part), overlap,
                          pad_to=pad_to)
    return topo, elem_part


def topology_inputs(
    disc: Discretization, elem_part: np.ndarray
) -> tuple[sps.csr_matrix, sps.csr_matrix, np.ndarray]:
    """The inputs of :func:`build_topology` for the element partition
    ``elem_part``: (dof adjacency, non-overlapping dof membership, owning
    subdomain of each dof)."""
    dofs = disc.dof_tuples()
    n_parts = int(elem_part.max()) + 1
    M0 = dof_membership_from_elems(dofs, elem_part, disc.n_dofs, n_parts)
    owner = dof_owner_lowest(dofs, elem_part, disc.n_dofs)
    return disc.adjacency(), M0, owner
