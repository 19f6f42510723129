"""Two-level Schwarz orchestration.

Counterpart of ``ddm_tpu/precond/two_level.py`` (reference:
TwoLevelSchwarzPreconditioner, examples/pdelab_schwarz.hh:26-205): the
fine-level Schwarz preconditioner plus a coarse space plus the Galerkin
correction, combined additively or multiplicatively, with the ten coarse
spaces of the JAX package.
"""

from __future__ import annotations

from ..config import ParamTree
from .combined import build_combined
from .galerkin import build_galerkin
from .schwarz import build_schwarz


def build_coarse_space(p, cs_type: str, ptree: ParamTree, fine=None):
    """Dispatch on ``coarsespace.type`` (pdelab_schwarz.hh:93-141)."""
    if cs_type == "pou":
        from ..coarse.pou_space import pou_coarse_space, rigid_body_modes

        templates = None
        if p.disc.n_comp > 1:
            templates = rigid_body_modes(p.disc.grid.nodes, p.disc.n_comp)
        return pou_coarse_space(
            p.topo, p.pou, templates=templates,
            dirichlet_mask=p.disc.dirichlet_mask, device=p.device,
        )
    if cs_type in ("geneo", "algebraic_geneo", "constraint_geneo"):
        from ..coarse.geneo import geneo_coarse_space

        return geneo_coarse_space(
            p, ptree, algebraic=cs_type == "algebraic_geneo",
            constrained=cs_type == "constraint_geneo")
    if cs_type == "geneo_ring":
        from ..coarse.ring import geneo_ring_coarse_space

        # the ring extension may reuse the fine level's explicit inverse
        return geneo_ring_coarse_space(p, ptree, fine=fine)
    if cs_type == "msgfem_ring":
        from ..coarse.ring import msgfem_ring_coarse_space

        return msgfem_ring_coarse_space(p, ptree, fine=fine)
    if cs_type in ("msgfem", "algebraic_msgfem", "msgfem_euclid"):
        from ..coarse.msgfem import msgfem_coarse_space

        return msgfem_coarse_space(p, ptree, variant=cs_type)
    if cs_type == "harmonic_extension":
        from ..coarse.harmonic import harmonic_extension_coarse_space

        return harmonic_extension_coarse_space(p, ptree)
    if cs_type == "svd":
        from ..coarse.svd import svd_coarse_space

        return svd_coarse_space(p, ptree)
    raise ValueError(f"Unknown coarse space type '{cs_type}'")


# coarse spaces whose construction reuses the fine level's explicit inverse:
# the fine level is built first for them; every other coarse basis is built
# before the fine factorization, so peak memory holds either the GEVP
# pencils or the fine inverse, not both
_CS_NEEDS_FINE = {"geneo_ring", "msgfem_ring"}


def build_two_level(p, fine=None):
    """p: api.DDMProblem.  Returns the combined two-level preconditioner.
    ``fine``: a Schwarz level of ``p`` built already (:func:`build_schwarz`),
    reused in place of a new one; with ``coarsespace.type = none`` it is
    returned as it is.  Under ``core.mesh.setup_sharding`` the coarse
    space is built for the rank's slab of subdomains (its functions see a
    problem whose topology and POU are that slab), the fine level cuts its
    slab itself, and the Galerkin build gathers what couples the slabs; a
    given ``fine`` must then have been built under the same mesh, and one
    built without it raises ``ValueError``, as ``solve_sharded`` refuses
    such a preconditioner."""
    from ..core.mesh import active_setup, local_problem

    if fine is not None:
        ctx = active_setup()
        mesh = ctx.mesh if ctx is not None else None
        if fine.mesh != mesh:
            raise ValueError(
                f"the fine level holds {fine.sub2glob.shape[0]} subdomains "
                "built under another mesh: build it under the same "
                "setup_sharding")
    ptree = p.ptree
    cs_type = ptree.sub("coarsespace").get("type", "geneo")
    if cs_type == "none":
        return fine if fine is not None else build_schwarz(
            p.A, p.topo, p.pou, ptree)
    if fine is None and cs_type in _CS_NEEDS_FINE:
        fine = build_schwarz(p.A, p.topo, p.pou, ptree)
    basis = build_coarse_space(local_problem(p), cs_type, ptree, fine=fine)
    coarse_ptree = ptree if "coarse_solver.type" in ptree else None
    # every coarse space built here is POU-finalized (vanishes on subdomain
    # boundaries), so the pairwise-local coarse matrix is exact; a basis that
    # clears boundary_vanishing gets the always-exact global formula
    method = ptree.sub("coarse_solver").get("matrix_method", "pairs")
    if method == "pairs" and not basis.boundary_vanishing:
        method = "global"
    coarse = build_galerkin(p.A, p.topo, basis, coarse_ptree, method=method)
    if fine is None:
        fine = build_schwarz(p.A, p.topo, p.pou, ptree)
    mode = ptree.sub("combined_preconditioner").get("mode", "additive")
    op = p.A if mode == "multiplicative" else None
    return build_combined([fine, coarse], ptree, op=op)
