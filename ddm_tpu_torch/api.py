"""Convenience API: one-call setup of DDM solvers for the shipped problems.

Counterpart of ``ddm_tpu/api.py`` (reference: the example drivers,
examples/poisson.cc, pdelab_example.cc): grid -> discretization -> topology
-> POU -> preconditioners -> Krylov solve from one config tree with the
reference's key names.  The problem lives on the CUDA card unless the
caller passes ``device="cpu"``; without CUDA, leaving ``device`` out raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .config import ParamTree
from .core.indexmaps import DDMTopology, pou_weights
from .core.setup import setup_topology
from .core.sparse import SparseELL, jacobi_equilibrate
from .fem import problems as problems_mod
from .fem.discretize import Discretization
from .fem.grids import structured_grid
from .fem.msh import read_msh
from .obs.logger import scoped
from .solvers.krylov import KrylovResult, solve_from_config


def default_ptree() -> ParamTree:
    return ParamTree(
        {
            "overlap": 2,
            "solver": {"type": "restartedgmressolver", "reduction": 1e-10,
                       "maxit": 1000, "restart": 50},
            "schwarz": {"type": "restricted",
                        "subdomain_solver": {"type": "cholesky"}},
            "pou": {"type": "distance", "shrink": 0},
            "coarsespace": {"type": "none"},
        }
    )


@dataclass
class DDMProblem:
    """Everything needed to run solves on one assembled problem.

    ``A``/``rhs`` are the (optionally Jacobi-equilibrated) constrained
    system on ``device``; ``scale`` transforms solutions back
    (x = scale * z, None if not equilibrated).  ``topo`` and ``pou`` are
    host numpy."""

    disc: Discretization | None
    topo: DDMTopology
    A: SparseELL
    rhs: torch.Tensor
    g: torch.Tensor
    pou: np.ndarray
    ptree: ParamTree
    device: torch.device
    elem_part: np.ndarray | None = None
    scale: torch.Tensor | None = None
    # the preconditioner an example driver built and solved with (its
    # applies and factors); None for a problem built outside the drivers
    prec: object | None = None


def make_grid(ptree: ParamTree, dim: int = 2):
    """Grid from config (reference: ddm_utilities.hh:33-171 make_grid): the
    gmsh v2.2 file ``meshfile`` if given, else a structured grid with
    ``gridsize`` cells per axis; refined ``refine`` times (simplex meshes
    by edge midpoints)."""
    meshfile = ptree.get("meshfile", "")
    if meshfile:
        grid = read_msh(meshfile)
    else:
        gs = ptree.get("gridsize", 64)
        grid = structured_grid((gs,) * dim)
    refine_n = ptree.get("refine", 0)
    if refine_n:
        from .fem.grids import refine

        grid = refine(grid, refine_n)
    return grid


def default_device() -> torch.device:
    """The current CUDA device; raises when CUDA is not available — the
    port never falls back to the CPU unless asked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def setup_problem(
    ptree: ParamTree | None = None,
    problem=None,
    grid=None,
    n_sub: int | None = None,
    parts: tuple[int, ...] | None = None,
    n_comp: int = 1,
    device=None,
) -> DDMProblem:
    """Grid, discretization, topology and POU per config, on ``device``
    (default: the CUDA card, see :func:`default_device`).  ``n_comp`` > 1
    takes an :class:`~.fem.problems.ElasticityProblem` with that many
    unknowns per node."""
    device = default_device() if device is None else torch.device(device)
    ptree = ptree or default_ptree()
    problem = problem or problems_mod.PROBLEMS[ptree.get("problem", "simple")]()
    with scoped("Setup", "grid (host)"):
        grid = grid if grid is not None else make_grid(ptree)
    with scoped("Setup", "discretize (host pattern)", device):
        disc = Discretization(grid, problem, device, n_comp=n_comp)
    with scoped("Setup", "assemble + constrain", device):
        A, rhs, g = disc.constrained_system()
    scale = None
    if ptree.get("equilibrate", True):
        with scoped("Setup", "equilibrate", device):
            A, rhs, scale = jacobi_equilibrate(A, rhs)
    if parts is None and n_sub is None:
        n_sub = ptree.get("subdomains", 4)
    with scoped("Setup", "topology (host)"):
        topo, elem_part = setup_topology(
            disc, overlap=ptree.get("overlap", 2), n_sub=n_sub, parts=parts
        )
    with scoped("Setup", "pou (host)"):
        pou = pou_weights(
            topo,
            ptree.sub("pou").get("type", "distance"),
            shrink=ptree.sub("pou").get("shrink", 0),
        )
    return DDMProblem(
        disc=disc, topo=topo, A=A, rhs=rhs, g=g, pou=pou, ptree=ptree,
        device=device, elem_part=elem_part, scale=scale,
    )


def build_preconditioner(p: DDMProblem, mesh=None):
    """One- or two-level preconditioner per config (``coarsespace.type``).

    With ``mesh`` (a ``core.mesh.SubdomainMesh`` on ``p``'s device; every
    rank holds the same problem and calls this together) the whole setup
    runs sharded (``core.mesh.setup_sharding``): the rank builds the
    extraction, factorization, eigensolves and coarse basis of its slab of
    subdomains only, and the coarse matrix and its factor replicated.
    Pass the same mesh to :func:`solve`."""
    from .precond.two_level import build_two_level

    if mesh is None:
        return build_two_level(p)
    from .core.mesh import setup_sharding

    if mesh.device != p.device:
        raise ValueError(f"the mesh's device {mesh.device} is not the "
                         f"problem's {p.device}")
    with setup_sharding(mesh, p.topo.n_sub):
        return build_two_level(p)


def solve(p: DDMProblem, prec=None, mesh=None) -> KrylovResult:
    """Krylov solve from config (subtree ``solver``), from a zero guess.
    With ``mesh``, the preconditioner's subdomain batch is sharded over its
    ranks (``core.mesh.solve_sharded``): every rank runs the same
    iterations on replicated vectors and returns the same result."""
    prec = prec if prec is not None else build_preconditioner(p, mesh=mesh)
    x0 = torch.zeros_like(p.rhs)
    with scoped("Solver", "solve", p.device):
        if mesh is not None:
            from .core.mesh import solve_sharded

            return solve_sharded(p.A, prec, p.rhs, x0, p.ptree, mesh,
                                 p.topo.n_sub)
        return solve_from_config(p.A.mv, prec.apply, p.rhs, x0, p.ptree,
                                 "solver")


def solution(p: DDMProblem, res: KrylovResult) -> torch.Tensor:
    """Assemble the full solution u = g + (scale*) z."""
    z = res.x if p.scale is None else p.scale * res.x
    return p.g + z
