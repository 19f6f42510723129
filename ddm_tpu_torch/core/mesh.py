"""Subdomain-axis SPMD execution over ``torch.distributed``: the port's
multi-device path.

Counterpart of ``ddm_tpu/core/mesh.py`` (reference: one subdomain per MPI
rank moving data with DUNE parallel index sets, SURVEY.md §2.6, §5.8;
dune/ddm/overlap_extension.hh:53-285, galerkin_preconditioner.hh:151-194).
W ranks each own a contiguous slab ``[lo, hi)`` of the subdomain batch:
rank r owns subdomains r*n_sub/W ... (r+1)*n_sub/W - 1.  The problem
(operator, right-hand side, topology) is replicated on every rank, as the
JAX package's host builds it once.  The collectives the algorithms need:

* fine-level halo sum (addOwnerCopyToOwnerCopy) -> ``all_gather`` of the
  ranks' (n_loc, n_pad) solution slabs into the full batch, then the same
  fixed-order gather-dual sum on every rank (precond/schwarz.py);
* coarse defect (the reference's rank-0 Gatherv) -> ``all_gather`` of the
  (n_loc, nev) restrictions, a coarse solve replicated on every rank, each
  rank prolonging its own slab (precond/galerkin.py);
* everything else (Krylov dots, SpMV) runs on replicated vectors.

The JAX package instead ``psum``s zero-embedded partial scatters: the same
sum in another rounding order for each device count.  Summing the gathered
batch in one fixed order gives every rank, and every W, the same bits.  The
Krylov loops decide on host floats (solvers/krylov.py), so a rank whose
iterate differed by one ulp could stop one iteration before the others and
leave them waiting in a collective.

The setup is sharded by hand, where the JAX package leaves it to GSPMD:
under :class:`setup_sharding` the builders cut their per-subdomain stages
to the rank's slab (:func:`local_topology`, :func:`local_problem`,
:func:`local_rows`), gather what couples subdomains (:func:`replicate`)
and take what the single-device build reduces over the whole batch over
every rank (:func:`batch_max`: padded widths, escalation decisions).

Backends: NCCL when every rank has a card of its own, gloo otherwise (NCCL
refuses two ranks on one card) and on the CPU.  Gloo's all_gather,
all_gather_into_tensor, all_reduce and broadcast take CUDA tensors in the
PyTorch of the card's machine (2.11), so no collective is staged by hand.
"""

from __future__ import annotations

import dataclasses
import datetime
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

# a rank that diverges ends the run with an error after this long in one
# collective, instead of hanging it
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def rank_device(device, rank: int) -> torch.device:
    """The rank's device: the CPU when asked for, else the card
    ``rank % device_count`` (one card per rank when there are enough,
    else ranks share them).  Without CUDA and without ``device="cpu"``
    this raises, as ``api.setup_problem`` does."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclass
class SubdomainMesh:
    """The ranks of one process group over the subdomain batch."""

    group: object  # torch.distributed ProcessGroup; None: the default group
    rank: int
    size: int  # W
    device: torch.device
    backend: str

    def slab(self, n_sub: int) -> tuple[int, int]:
        """This rank's subdomains ``[lo, hi)`` of a batch of ``n_sub``."""
        if n_sub % self.size:
            raise ValueError(
                f"subdomain count {n_sub} must divide evenly over the "
                f"{self.size} ranks")
        k = n_sub // self.size
        return self.rank * k, (self.rank + 1) * k

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (the same shape on every rank) concatenated
        along dim 0 in rank order, on every rank."""
        if self.size == 1:
            return x
        src = x.contiguous()
        if x.dtype == torch.bool:  # NCCL moves no bool
            src = src.to(torch.uint8)
        out = src.new_empty((self.size,) + tuple(src.shape))
        dist.all_gather(list(out.unbind(0)), src, group=self.group)
        return out.reshape((-1,) + tuple(src.shape[1:])).to(x.dtype)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


def init_ranks(rank: int, world_size: int, init_method: str, device=None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> SubdomainMesh:
    """Join the default process group as ``rank`` of ``world_size``
    (``init_method``: ``file://<path>`` or ``tcp://localhost:<port>``) and
    return its mesh.  The backend follows the device: NCCL when every rank
    has a card of its own, else gloo (NCCL refuses two ranks on one card,
    and gloo is the CPU's backend)."""
    dev = rank_device(device, rank)
    backend = "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if torch.cuda.device_count() >= world_size:
            backend = "nccl"
    # NCCL bound to the rank's card at once: its communicator is made here,
    # not inside the first collective of the setup
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout,
                            device_id=dev if backend == "nccl" else None)
    return subdomain_mesh(device=dev)


def subdomain_mesh(group=None, device=None) -> SubdomainMesh:
    """The mesh over an initialized process group (default: the default
    group), on the rank's device (:func:`rank_device`)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call init_ranks or "
            "torch.distributed.init_process_group first")
    return SubdomainMesh(
        group=group, rank=dist.get_rank(group),
        size=dist.get_world_size(group),
        device=rank_device(device, dist.get_rank()),
        backend=str(dist.get_backend(group)))


# ---------------------------------------------------------------------------
# Sharded setup: the per-subdomain stages run on the rank's slab; the stages
# that couple subdomains gather what they read and compute replicated.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SetupSlab:
    mesh: SubdomainMesh
    n_sub: int  # the full batch
    lo: int
    hi: int


_SETUP: list[SetupSlab] = []


class setup_sharding:
    """Context manager under which the setup builders work on the rank's
    slab of a batch of ``n_sub`` subdomains (raises ``ValueError`` when
    ``n_sub`` does not divide over the ranks)."""

    def __init__(self, mesh: SubdomainMesh, n_sub: int):
        lo, hi = mesh.slab(n_sub)
        self.entry = SetupSlab(mesh, n_sub, lo, hi)

    def __enter__(self):
        _SETUP.append(self.entry)
        return self.entry

    def __exit__(self, *exc):
        _SETUP.pop()
        return False


def active_setup() -> SetupSlab | None:
    """The innermost active :class:`setup_sharding`'s slab, or None."""
    return _SETUP[-1] if _SETUP else None


def _slab_case(n: int, what: str, ctx: SetupSlab) -> bool:
    """True when a leading dimension ``n`` is the full batch (to be cut),
    False when it is already the rank's slab; any other size raises."""
    if n == ctx.n_sub:
        return True
    if n == ctx.hi - ctx.lo:
        return False
    raise ValueError(f"{what} holds {n} subdomains: neither the batch of "
                     f"{ctx.n_sub} nor this rank's slab of {ctx.hi - ctx.lo}")


def local_rows(x):
    """Rows ``[lo, hi)`` of a full-batch array (leading dimension the
    active context's n_sub); a slab (leading dimension hi - lo) passes
    through, any other size raises ``ValueError``.  ``x`` itself outside a
    context."""
    ctx = active_setup()
    if ctx is None or x is None or not _slab_case(x.shape[0], "array", ctx):
        return x
    return x[ctx.lo:ctx.hi]


def slice_topology(topo, lo: int, hi: int):
    """The topology of subdomains ``[lo, hi)`` alone, renumbered from 0:
    the per-subdomain maps cut to the slab, the global->local keys cut and
    rebased; global fields (``dof_owner``, n_glob, n_pad) unchanged."""
    n1 = np.int64(topo.n_glob + 1)
    a, b = np.searchsorted(topo.g2l_keys, [lo * n1, hi * n1])
    return dataclasses.replace(
        topo, n_sub=hi - lo, sub2glob=topo.sub2glob[lo:hi],
        valid=topo.valid[lo:hi], owner=topo.owner[lo:hi],
        boundary=topo.boundary[lo:hi], bdist=topo.bdist[lo:hi],
        g2l_keys=topo.g2l_keys[a:b] - lo * n1, g2l_locs=topo.g2l_locs[a:b],
        membership=topo.membership[lo:hi], sizes=topo.sizes[lo:hi])


def local_topology(topo):
    """The rank's slab of ``topo`` under an active context (a topology
    that is already the slab passes through, any other size raises
    ``ValueError``); ``topo`` outside one."""
    ctx = active_setup()
    if ctx is None or not _slab_case(topo.n_sub, "topology", ctx):
        return topo
    return slice_topology(topo, ctx.lo, ctx.hi)


def local_problem(p):
    """``api.DDMProblem`` ``p`` with its topology and POU cut to the
    rank's slab under an active context; ``p`` outside one."""
    if active_setup() is None:
        return p
    return dataclasses.replace(p, topo=local_topology(p.topo),
                               pou=local_rows(p.pou))


def replicate(x: torch.Tensor) -> torch.Tensor:
    """The full batch of a rank-local slab ``x`` (leading dimension
    hi - lo), gathered from every rank; ``x`` itself outside a context.
    Pulls the cross-subdomain quantities (the coarse basis, its activity
    mask) out of the sharded batch before replicated compute."""
    ctx = active_setup()
    if ctx is None or ctx.mesh.size == 1:
        return x
    if x.shape[0] != ctx.hi - ctx.lo:
        raise ValueError(f"replicate takes a slab of {ctx.hi - ctx.lo} "
                         f"subdomains, got {tuple(x.shape)}")
    return ctx.mesh.all_gather(x)


def batch_max(v):
    """The largest ``v`` over every rank under an active context (one
    all-gather; every rank calls it together), ``v`` itself outside one.
    For what the single-device build takes over the whole batch: a padded
    width (a slab's own maximum would pad its batched solves to another
    size, which rounds differently) and a host decision (a rank deciding on
    its slab alone could take another route than the others)."""
    ctx = active_setup()
    if ctx is None or ctx.mesh.size == 1:
        return v
    t = torch.tensor([v], dtype=torch.float64, device=ctx.mesh.device)
    return type(v)(ctx.mesh.all_gather(t).max().item())


# ---------------------------------------------------------------------------
# Sharded solve
# ---------------------------------------------------------------------------

def _components(prec):
    from ..precond.combined import CombinedPreconditioner

    if isinstance(prec, CombinedPreconditioner):
        for q in prec.precs:
            yield from _components(q)
    else:
        yield prec


def solve_sharded(ell, prec, b: torch.Tensor, x0: torch.Tensor, ptree,
                  mesh: SubdomainMesh, n_sub: int,
                  subtree_name: str = "solver"):
    """Krylov solve with the preconditioner's subdomain batch sharded over
    ``mesh``: the operator and the vectors are replicated, every rank runs
    the same iterations and returns the same result.  ``prec`` must have
    been built under the same mesh (``api.build_preconditioner(p,
    mesh=)``); a full-batch one raises."""
    from ..solvers.krylov import solve_from_config

    lo, hi = mesh.slab(n_sub)
    for q in _components(prec):
        if getattr(q, "mesh", mesh) != mesh:
            raise ValueError(
                f"{type(q).__name__} holds {q.sub2glob.shape[0]} subdomains, "
                f"not this rank's {hi - lo}: build it with the same mesh")
    return solve_from_config(ell.mv, prec.apply, b, x0, ptree, subtree_name)
