"""Two-level Schwarz orchestration.

Counterpart of ``ddm_tpu/precond/two_level.py`` (reference:
TwoLevelSchwarzPreconditioner, examples/pdelab_schwarz.hh:26-205): the
fine-level Schwarz preconditioner plus a coarse space plus the Galerkin
correction, combined additively.  Only the ``geneo`` coarse space is ported.
"""

from __future__ import annotations

from .combined import build_combined
from .galerkin import build_galerkin
from .schwarz import build_schwarz


def build_two_level(p):
    """p: api.DDMProblem.  Returns the combined two-level preconditioner.

    The coarse basis is built before the fine factorization, as in the TPU
    package, so peak memory holds either the GEVP pencils or the fine
    inverse, not both."""
    ptree = p.ptree
    cs_type = ptree.sub("coarsespace").get("type", "geneo")
    if cs_type == "none":
        return build_schwarz(p.A, p.topo, p.pou, ptree)
    if cs_type != "geneo":
        raise NotImplementedError(f"coarse space '{cs_type}' is not ported")
    from ..coarse.geneo import geneo_coarse_space

    basis = geneo_coarse_space(p, ptree)
    coarse_ptree = ptree if "coarse_solver.type" in ptree else None
    coarse = build_galerkin(p.A, p.topo, basis, coarse_ptree)
    fine = build_schwarz(p.A, p.topo, p.pou, ptree)
    return build_combined([fine, coarse], ptree)
