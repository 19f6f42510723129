"""MsGFEM coarse space (Multiscale GFEM with the A-harmonicity constraint).

Counterpart of ``ddm_tpu/coarse/msgfem.py`` (reference: MsGFEMCoarseSpace,
coarse_spaces.hh:663-831).  The reference builds a saddle-point pencil with
Lagrange-multiplier blocks enforcing (A_dir u)_i = 0 in the subdomain
interior; the eigenproblem lives on the A-harmonic subspace, so the reduced
pencil is solved directly:

    u = H w   (H = harmonic parameter basis, extension.py)
    Ahat = H^T A_nrg H,   Bhat = H^T P_int (D A_nrg D) P_int H
    Ahat w = lambda Bhat w,  smallest lambda kept

the same spectrum as the saddle formulation's finite eigenvalues.  The
reduced pencil goes straight to the dense solver, whatever
``eigensolver.type`` says, as in the JAX package.

Variants (examples/pdelab_schwarz.hh:102-135):

* ``msgfem``:           A_nrg = subdomain Neumann matrix;
* ``msgfem_euclid``:    A_nrg = I (Euclidean energy);
* ``algebraic_msgfem``: A_nrg = algebraic Neumann (Al Daas et al.), solved
  as an indefinite pencil.

The constraint matrix is A_dir in all three.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ParamTree
from ..eigen import solve_gevp_dense_slabs
from ..eigen.params import EigensolverParams
from ..obs.logger import scoped
from ..solvers.direct import batch_chunk_size, chunked_batch
from .basis import CoarseBasis, finalize_basis
from .extension import harmonic_parameter_basis
from .geneo import algebraic_neumann, dirichlet_dense, neumann_matrices

VARIANTS = ("msgfem", "msgfem_euclid", "algebraic_msgfem")


def msgfem_coarse_space(p, ptree: ParamTree,
                        variant: str = "msgfem") -> CoarseBasis:
    """p: api.DDMProblem.  Config subtree ``<variant>.eigensolver``."""
    if variant not in VARIANTS:
        raise ValueError(f"Unknown msgfem variant '{variant}'")
    topo, device = p.topo, p.device
    params = EigensolverParams.from_ptree(ptree.sub(f"{variant}.eigensolver"))
    pou = torch.as_tensor(p.pou, dtype=torch.float64, device=device)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    A_dir, dmask = dirichlet_dense(p)
    dmask_np = dmask.cpu().numpy()
    boundary = np.asarray(topo.boundary)
    valid = t(topo.valid)
    im = t(topo.valid & ~boundary & ~dmask_np)  # the constrained interior
    par = t(topo.valid & boundary & ~dmask_np)  # the parameters

    if variant == "msgfem":
        A_nrg, _ = neumann_matrices(p, region_b="all")
    elif variant == "msgfem_euclid":
        A_nrg = torch.eye(topo.n_pad, dtype=torch.float64,
                          device=device).expand(topo.n_sub, -1, -1)
    else:
        A_nrg, _ = algebraic_neumann(p)
    nd = valid & ~dmask
    A_nrg = torch.where(nd[:, :, None] & nd[:, None, :], A_nrg, 0.0)
    # rhs weight: POU-scaled A_nrg restricted to interior-interior pairs
    B = torch.where(im[:, :, None] & im[:, None, :],
                    A_nrg * pou[:, :, None] * pou[:, None, :], 0.0)

    # H is a full (n_sub, p, p) batch from an LU with p right-hand sides:
    # slabs keep the LU, its right-hand sides and H of one slab alive
    with scoped("Eigensolver", "harmonic basis", device):
        H, = chunked_batch(
            lambda a, i, b: (harmonic_parameter_basis(a, i, b),),
            A_dir, im, par,
            chunk=batch_chunk_size(topo.n_pad, live_buffers=5))
    del A_dir
    with scoped("Eigensolver", "reduced pencil", device):
        Ahat = H.mT @ A_nrg @ H
        Bhat = H.mT @ B @ H
        del A_nrg, B
        Ahat = Ahat + torch.diag_embed((~par).to(Ahat.dtype))
    with scoped("Eigensolver", "solve GEVP", device):
        _, W, active = solve_gevp_dense_slabs(
            Ahat, Bhat, params, spd=variant != "algebraic_msgfem")
    del Ahat, Bhat
    V = torch.einsum("spq,skq->skp", H, W)
    V = torch.where(valid[:, None, :], V, 0.0)
    return finalize_basis(V, pou, valid, active)
