"""One-level (restricted) additive Schwarz preconditioner, batched.

Counterpart of ``ddm_tpu/precond/schwarz.py`` (reference:
dune/ddm/schwarz.hh:35-220).  The per-rank sequence copy defect -> halo
copy -> subdomain solve -> POU scale -> halo add becomes

    gather (n_sub, n_pad) -> batched subdomain solve -> POU mask ->
    fixed-order scatter-add

with the subdomain factorizations held as one dense batch.  Built under
``core.mesh.setup_sharding``, a rank holds its slab of the batch only; its
apply gathers the ranks' solution slabs into the full batch and takes the
same fixed-order sum as the single-device apply.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import ParamTree
from ..core.indexmaps import DDMTopology, dual_scatter_map, extraction_map
from ..core.mesh import SubdomainMesh, active_setup, local_rows, local_topology
from ..core.sparse import SparseELL
from ..obs.logger import scoped
from ..fem.subassembly import eliminate_dirichlet_dense
from ..solvers.direct import BatchedInverseDD, SparseRefinedInverse, factor_batched
from .extract import extract_subdomain_dense, gather_subdomain, scatter_add_subdomain


@dataclass
class SchwarzPreconditioner:
    sub2glob: torch.Tensor  # (n_sub, n_pad) int64
    valid: torch.Tensor  # (n_sub, n_pad) bool
    pou: torch.Tensor  # (n_sub, n_pad) f64; all ones for standard AS
    # BatchedCholesky | BatchedLU | BatchedInverse | BatchedInverseDD |
    # SparseRefinedInverse
    factors: object
    # (K, n) int64 gather-dual of the scatter; its flat indices address
    # the full subdomain batch, also when this rank holds a slab of it
    dualT: torch.Tensor
    applies: int = 0  # number of apply() calls so far
    # the ranks over the subdomain batch when the batched fields above are
    # this rank's slab (core/mesh.py), else None
    mesh: SubdomainMesh | None = None

    def apply(self, d: torch.Tensor) -> torch.Tensor:
        self.applies += 1
        d_sub = gather_subdomain(d, self.sub2glob)
        x_sub = self.factors.solve(d_sub)
        x_sub = torch.where(self.valid, x_sub * self.pou, 0.0)
        if self.mesh is not None:
            x_sub = self.mesh.all_gather(x_sub)
        return scatter_add_subdomain(x_sub, self.dualT)


def build_schwarz(
    ell: SparseELL,
    topo: DDMTopology,
    pou: np.ndarray | None,
    ptree: ParamTree | None = None,
    subtree_name: str = "schwarz",
) -> SchwarzPreconditioner:
    """Set up the Schwarz preconditioner on ``ell``'s device (reference
    ctor schwarz.hh:73-94).

    Config keys (subtree ``schwarz``): ``type`` = standard|restricted
    (default restricted); ``subdomain_solver.type`` (mandatory, lu with
    ``ptree`` None; cholesky /
    cholmod, or lu / umfpack / superlu); ``subdomain_solver.precision`` =
    f64|dd|f32, where dd (a double-single inverse applied through
    kernels/ddmatvec.py) and f32 (an f32 inverse, ``SparseRefinedInverse``)
    both take ``subdomain_solver.refine_steps`` exact sparse f64 defect
    corrections per apply, default 2.  ``modify_subdomain_matrix`` (top
    level) eliminates each subdomain's boundary dofs from its matrix before
    factorising (reference: pdelab_schwarz.hh:163-164).  The TPU
    construction knobs ``construction`` and ``newton_rtol`` are accepted and
    ignored: the inverse is always built exactly in f64.  Under
    ``setup_sharding`` everything but the scatter map is built for the
    rank's slab alone."""
    ptree = ptree or ParamTree(
        {subtree_name: {"subdomain_solver": {"type": "lu"}}})
    device = ell.vals.device
    ctx = active_setup()
    dual = dual_scatter_map(topo)  # of the full batch
    topo, pou = local_topology(topo), local_rows(pou)
    sub = ptree.sub(subtree_name)
    type_string = sub.get("type", "restricted")
    if type_string not in ("standard", "restricted"):
        raise ValueError(f"Unknown Schwarz type '{type_string}'")
    solver_sub = sub.sub("subdomain_solver")
    if "type" not in solver_sub:
        raise KeyError(
            f"You must specify the solver in the subtree {subtree_name}."
            "subdomain_solver using the key 'type'"
        )
    solver_type = solver_sub.get("type")
    precision = solver_sub.get("precision", "f64")
    if precision not in ("f64", "dd", "f32"):
        raise ValueError(f"Unknown subdomain precision '{precision}'")

    def t(a):
        return torch.as_tensor(a, device=device)

    local_cols = t(extraction_map(topo, ell.cols.cpu().numpy()).astype(np.int64))
    sub2glob = t(topo.sub2glob.astype(np.int64))
    valid = t(topo.valid)
    with scoped("Schwarz", "extract", device):
        A_sub = extract_subdomain_dense(ell, sub2glob, valid, local_cols)
        if ptree.get("modify_subdomain_matrix", False):
            eliminate_dirichlet_dense(A_sub, t(topo.boundary) & valid,
                                      inplace=True)
    with scoped("Schwarz", "factorise", device):
        # the reduced-precision applies need the explicit inverse, on the
        # CPU too (where "auto" keeps triangular factors)
        factors = factor_batched(
            A_sub, solver_type, mode="auto" if precision == "f64" else "inverse",
            store_dtype={"dd": "dd", "f32": torch.float32}.get(precision))
        del A_sub
    if precision != "f64":
        # each subdomain's sparse rows of A, for the exact defect corrections
        rows = torch.clamp(sub2glob, max=ell.n - 1)
        sub_vals, _ = ell.rows_dense_gather(rows)
        sub_vals = sub_vals * valid[:, :, None]
        sub_vals = torch.where(local_cols >= topo.n_pad, 0.0, sub_vals)
        steps = int(solver_sub.get("refine_steps", 2))
        if precision == "dd":
            factors = BatchedInverseDD(
                inv_hi=factors.inv_hi, inv_lo=factors.inv_lo,
                sub_vals=sub_vals, sub_cols=local_cols, steps=steps)
        else:
            factors = SparseRefinedInverse(
                inv32=factors.inv, sub_vals=sub_vals, sub_cols=local_cols,
                steps=steps)

    if type_string == "restricted":
        if pou is None:
            raise ValueError("restricted Schwarz requires a partition of unity")
        pou_t = torch.as_tensor(pou, dtype=torch.float64, device=device)
    else:
        pou_t = torch.ones(topo.sub2glob.shape, dtype=torch.float64,
                           device=device)
    return SchwarzPreconditioner(
        sub2glob=sub2glob, valid=valid, pou=pou_t, factors=factors,
        dualT=t(dual.astype(np.int64)),
        mesh=ctx.mesh if ctx is not None else None,
    )
