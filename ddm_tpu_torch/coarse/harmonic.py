"""Harmonic-extension coarse space.

Counterpart of ``ddm_tpu/coarse/harmonic.py`` (reference:
coarse_spaces.hh:1233-1266, pdelab_schwarz.hh:112-124): random boundary
data, extended energy-minimally into the subdomain interior, then
POU-finalized.

Config: ``harmonic_extension.n_basis_vectors`` (default 8) and the
top-level ``seed`` (default 1).  The data come from
``numpy.random.default_rng(seed)``, as in the JAX package, so both draw the
same vectors.  (The reference's example program reads n_basis_vectors but
allocates one vector per boundary dof, pdelab_schwarz.hh:117-121; the
intended n_basis_vectors semantics are used here.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ParamTree
from ..core.mesh import active_setup, local_rows
from .basis import CoarseBasis, finalize_basis
from .extension import energy_minimal_extension
from .geneo import dirichlet_dense


def harmonic_extension_coarse_space(p, ptree: ParamTree) -> CoarseBasis:
    topo, device = p.topo, p.device
    nev = ptree.sub("harmonic_extension").get("n_basis_vectors", 8)
    rng = np.random.default_rng(ptree.get("seed", 1))

    A_dir, _ = dirichlet_dense(p)
    valid = torch.as_tensor(topo.valid, device=device)
    boundary = valid & torch.as_tensor(topo.boundary, device=device)
    # drawn for the full batch, so a rank's slab (core/mesh.py) gets the
    # rows the single-device build gives those subdomains
    ctx = active_setup()
    n_full = topo.n_sub if ctx is None else ctx.n_sub
    data = torch.as_tensor(
        local_rows(rng.normal(size=(n_full, nev, topo.n_pad))), device=device)
    data = torch.where(boundary[:, None, :], data, 0.0)
    V = energy_minimal_extension(A_dir, valid & ~boundary, data,
                                 "cholesky")
    V = torch.where(valid[:, None, :], V, 0.0)
    active = torch.ones((topo.n_sub, nev), dtype=torch.bool, device=device)
    pou = torch.as_tensor(p.pou, dtype=torch.float64, device=device)
    return finalize_basis(V, pou, valid, active)
