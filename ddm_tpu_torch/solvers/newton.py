"""Newton's method with line search and inexact inner solves.

Counterpart of ``ddm_tpu/solvers/newton.py`` (reference: PDELab's
NewtonMethod as driven by examples/nonlinearpoisson.cc:153-171 and
twolevel_schwarz.hh:27-175):

* termination on ||r(u)|| <= max(Reduction * ||r(u0)||, AbsoluteLimit);
* Hackbusch-Reusken backtracking line search (damping, bounded trials),
  optionally accepting the best trial (PDELab's AcceptBest);
* inexact-Newton forcing: the inner Krylov reduction of a step is
  min(MinLinearReduction, (defect / previous defect)^2), floored at 1e-12,
  unless FixedLinearReduction is set (PDELab semantics).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..config import ParamTree
from ..obs.logger import warn


@dataclass
class NewtonResult:
    u: torch.Tensor
    iterations: int
    converged: bool
    defect0: float
    defect: float
    linear_iterations: int
    history: list  # the defect after each accepted step, defect0 first


def _norm(r: torch.Tensor) -> float:
    return float(torch.linalg.norm(r))


def newton_solve(
    residual_jacobian: Callable,  # u -> (r, J)
    linear_solve: Callable,  # (J, r, reduction) -> (dz, n_iters)
    u0: torch.Tensor,
    reduction: float = 1e-8,
    maxit: int = 40,
    abs_limit: float = 1e-12,
    min_linear_reduction: float = 1e-3,
    fixed_linear_reduction: bool = False,
    line_search_max: int = 10,
    line_search_damping: float = 0.5,
    line_search_accept_best: bool = False,
) -> NewtonResult:
    u = u0
    r, J = residual_jacobian(u)
    def0 = _norm(r)
    defect = prev = def0
    target = max(reduction * def0, abs_limit)
    history = [def0]
    lin_total = 0

    for it in range(1, maxit + 1):
        if defect <= target:
            return NewtonResult(u, it - 1, True, def0, defect, lin_total, history)
        lin_red = min_linear_reduction
        if not fixed_linear_reduction:
            # PDELab's forcing: the quadratic model of the expected decrease
            if it > 1:
                lin_red = min(lin_red, (defect / prev) ** 2)
            lin_red = max(lin_red, 1e-12)
        dz, n_lin = linear_solve(J, r, lin_red)
        lin_total += int(n_lin)

        # accept on the sufficient-decrease test
        # ||r(u - lam dz)|| < (1 - lam/4) ||r(u)|| (PDELab
        # LineSearchHackbuschReusken), else, with AcceptBest, the best
        # trial if it decreases the defect at all
        lam = 1.0
        best = best_seen = None
        for _ in range(line_search_max):
            u_try = u - lam * dz
            r_try, J_try = residual_jacobian(u_try)
            d_try = _norm(r_try)
            if best_seen is None or d_try < best_seen[3]:
                best_seen = (u_try, r_try, J_try, d_try)
            if d_try < (1.0 - lam / 4.0) * defect:
                best = (u_try, r_try, J_try, d_try)
                break
            lam *= line_search_damping
        if best is None and line_search_accept_best and best_seen[3] < defect:
            best = best_seen
        if best is None:
            warn("Newton line search failed at iteration {}", it)
            return NewtonResult(u, it, False, def0, defect, lin_total, history)
        u, r, J, d_new = best
        prev, defect = defect, d_new
        history.append(defect)

    return NewtonResult(u, maxit, defect <= target, def0, defect, lin_total,
                        history)


def newton_from_config(residual_jacobian, linear_solve, u0, ptree: ParamTree,
                       subtree_name: str = "newton") -> NewtonResult:
    """:func:`newton_solve` with PDELab's key names from subtree ``newton``."""
    sub = ptree.sub(subtree_name)
    return newton_solve(
        residual_jacobian,
        linear_solve,
        u0,
        reduction=sub.get("Reduction", 1e-8),
        maxit=sub.get("MaxIterations", 40),
        abs_limit=sub.get("AbsoluteLimit", 1e-12),
        min_linear_reduction=sub.get("MinLinearReduction", 1e-3),
        fixed_linear_reduction=sub.get("FixedLinearReduction", False),
        line_search_max=sub.get("LineSearchMaxIterations", 10),
        line_search_damping=sub.get("LineSearchDampingFactor", 0.5),
        line_search_accept_best=sub.get("LineSearchAcceptBest", False),
    )
