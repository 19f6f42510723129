"""Additive/multiplicative combination of preconditioners.

Counterpart of ``ddm_tpu/precond/combined.py`` (reference:
dune/ddm/combined_preconditioner.hh:21-180): additive mode sums the
applications (P = P1 + P2 + ...); multiplicative mode interleaves residual
updates (x_{i+1} = x_i + P_{i+1}(d - A x_i), combined_preconditioner.hh:
144-159) and therefore needs the operator (the ``op`` field).
Preconditioners are applied in the order given.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class CombinedPreconditioner:
    precs: tuple  # preconditioners with .apply, applied in order
    op: object | None = None  # operator with .mv (multiplicative only)
    mode: str = "additive"

    def apply(self, d: torch.Tensor) -> torch.Tensor:
        if len(self.precs) == 0:
            raise ValueError("No preconditioners to apply, add them via `precs`")
        x = self.precs[0].apply(d)
        if self.mode == "additive":
            for p in self.precs[1:]:
                x = x + p.apply(d)
        elif self.mode == "multiplicative":
            if self.op is None:
                raise ValueError(
                    "ApplyMode is multiplicative but operator A is not "
                    "provided. Set with `op`"
                )
            for p in self.precs[1:]:
                x = x + p.apply(d - self.op.mv(x))
        else:
            raise ValueError(
                f"Unknown apply mode '{self.mode}', use additive or "
                "multiplicative"
            )
        return x


def build_combined(precs, ptree=None, op=None,
                   subtree_name="combined_preconditioner"):
    mode = "additive"
    if ptree is not None:
        mode = ptree.sub(subtree_name).get("mode", "additive")
    return CombinedPreconditioner(precs=tuple(precs), op=op, mode=mode)
