"""Build the port's objects from numpy arrays of the JAX package's state.

With these, a test takes the state ``ddm_tpu`` computed (its operator, its
topology — which may use the TPU canvas slot order — its factors, basis and
coarse matrix), hands the arrays over, and compares one module at a time.
Every function takes numpy arrays and a ``device``; nothing here imports
``jax`` (the caller converts with ``np.asarray``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from .api import DDMProblem
from .coarse.basis import CoarseBasis
from .config import ParamTree
from .core.indexmaps import DDMTopology
from .core.sparse import SparseELL
from .precond.galerkin import GalerkinPreconditioner
from .precond.schwarz import SchwarzPreconditioner
from .solvers.direct import (
    BatchedCholesky,
    BatchedInverse,
    BatchedInverseDD,
    factor_batched,
)


def _i64(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a).astype(np.int64), device=device)


def _f64(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float64), device=device)


def topology_from_numpy(sub2glob, valid, bdist, boundary, overlap: int,
                        n_glob: int, dualT=None) -> DDMTopology:
    """A :class:`DDMTopology` over the given slot layout; the global->local
    keys and the membership are derived from ``sub2glob``/``valid``.  Dof
    ownership is not carried (no ported path reads it)."""
    sub2glob = np.asarray(sub2glob).astype(np.int32)
    valid = np.asarray(valid, dtype=bool)
    n_sub, n_pad = sub2glob.shape
    k, slot = np.nonzero(valid)
    ids = sub2glob[k, slot].astype(np.int64)
    keys = k.astype(np.int64) * (n_glob + 1) + ids
    order = np.argsort(keys)
    topo = DDMTopology(
        n_glob=n_glob, n_sub=n_sub, n_pad=n_pad, overlap=overlap,
        sub2glob=sub2glob, valid=valid,
        owner=np.zeros_like(valid),
        boundary=np.asarray(boundary, dtype=bool),
        bdist=np.asarray(bdist).astype(np.int32),
        bdist_cap=4 * overlap + 2,
        dof_owner=np.zeros(n_glob, dtype=np.int32),
        g2l_keys=keys[order], g2l_locs=slot[order].astype(np.int32),
        membership=sps.csr_matrix(
            (np.ones(k.size, dtype=bool), (k, ids)), shape=(n_sub, n_glob)
        ),
        sizes=valid.sum(axis=1),
    )
    if dualT is not None:
        object.__setattr__(topo, "_dual_scatter_map", np.asarray(dualT))
    return topo


def discretization_from_numpy(grid, problem, n_comp: int, dirichlet_mask,
                              dirichlet_values, *, device):
    """The port's Discretization of ``grid`` (the port's own Grid over the
    same nodes and elements) for a problem with ``n_comp`` unknowns per
    node, with the Dirichlet mask (repeated per component) and the
    flattened boundary data pinned to the arrays of the JAX package's
    discretization, so both packages constrain the same dofs to the same
    values."""
    from .fem.discretize import Discretization

    disc = Discretization(grid, problem, device, n_comp=n_comp)
    mask = torch.tensor(np.asarray(dirichlet_mask, bool), device=device)
    if mask.shape != (disc.n_dofs,):
        raise ValueError(f"mask must have n_dofs = {disc.n_dofs} entries")
    disc.__dict__["dirichlet_mask"] = mask
    disc.__dict__["dirichlet_values"] = _f64(dirichlet_values, device)
    return disc


def problem_from_numpy(
    colsT, valsT, rhs, g, scale, pou, sub2glob, valid, bdist, boundary,
    dualT, overlap: int, *, device, ptree: ParamTree | None = None,
    disc=None,
) -> DDMProblem:
    """DDMProblem from the JAX package's (slot-major) ELL operator, vectors
    and topology arrays.  ``colsT``/``valsT`` (m, n) become the row-major
    (n, m) ELL; ``disc`` (the port's own Discretization of the same grid)
    is only needed by the Neumann assembly."""
    device = torch.device(device)
    cols = np.ascontiguousarray(np.asarray(colsT).T)
    A = SparseELL(cols=_i64(cols, device),
                  vals=_f64(np.ascontiguousarray(np.asarray(valsT).T), device))
    n = cols.shape[0]
    topo = topology_from_numpy(sub2glob, valid, bdist, boundary, overlap, n,
                               dualT=dualT)
    return DDMProblem(
        disc=disc, topo=topo, A=A, rhs=_f64(rhs, device), g=_f64(g, device),
        pou=np.asarray(pou, dtype=np.float64), ptree=ptree or ParamTree(),
        device=device,
        scale=None if scale is None else _f64(scale, device),
    )


def schwarz_from_numpy(
    sub2glob, valid, pou, dualT, *, chol=None, inv=None, inv_hi=None,
    inv_lo=None, sub_vals=None, sub_cols=None, steps: int = 0, device,
) -> SchwarzPreconditioner:
    """Schwarz preconditioner over given subdomain factors: Cholesky
    factors ``chol``, an f64 inverse ``inv``, or a double-single inverse
    ``inv_hi``/``inv_lo`` (with ``sub_vals``/``sub_cols`` and ``steps``
    for the exact defect correction)."""
    if chol is not None:
        factors = BatchedCholesky(chol=_f64(chol, device))
    elif inv is not None:
        factors = BatchedInverse(inv=_f64(inv, device))
    else:
        factors = BatchedInverseDD(
            inv_hi=torch.tensor(np.asarray(inv_hi, np.float32), device=device),
            inv_lo=torch.tensor(np.asarray(inv_lo, np.float32), device=device),
            sub_vals=None if sub_vals is None else _f64(sub_vals, device),
            sub_cols=None if sub_cols is None else _i64(sub_cols, device),
            steps=steps,
        )
    return SchwarzPreconditioner(
        sub2glob=_i64(sub2glob, device),
        valid=torch.tensor(np.asarray(valid, bool), device=device),
        pou=_f64(pou, device), factors=factors, dualT=_i64(dualT, device),
    )


def basis_from_numpy(V, active, *, device) -> CoarseBasis:
    return CoarseBasis(
        V=_f64(V, device),
        active=torch.tensor(np.asarray(active, bool), device=device),
    )


def galerkin_from_numpy(E, V, active, sub2glob, dualT, refine: int = 2, *,
                        device) -> GalerkinPreconditioner:
    """Galerkin correction over a given coarse matrix ``E`` (factored here
    by Cholesky) and basis ``V``/``active``."""
    E_t = _f64(E, device)
    return GalerkinPreconditioner(
        sub2glob=_i64(sub2glob, device), V=_f64(V, device),
        active=torch.tensor(np.asarray(active, bool), device=device),
        coarse=factor_batched(E_t[None], "cholesky"),
        dualT=_i64(dualT, device),
        E_mat=E_t if refine > 0 else None, refine=refine,
    )
