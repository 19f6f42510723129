"""Additive combination of preconditioners (reference:
dune/ddm/combined_preconditioner.hh:21-180, additive mode: P = P1 + P2 + ...).
Counterpart of ``ddm_tpu/precond/combined.py``; the multiplicative mode is
not ported."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class CombinedPreconditioner:
    precs: tuple  # preconditioners with .apply, applied in order

    def apply(self, d: torch.Tensor) -> torch.Tensor:
        if len(self.precs) == 0:
            raise ValueError("No preconditioners to apply, add them via `precs`")
        x = self.precs[0].apply(d)
        for p in self.precs[1:]:
            x = x + p.apply(d)
        return x


def build_combined(precs, ptree=None, subtree_name="combined_preconditioner"):
    mode = "additive"
    if ptree is not None:
        mode = ptree.sub(subtree_name).get("mode", "additive")
    if mode != "additive":
        raise NotImplementedError(f"combined mode '{mode}' is not ported")
    return CombinedPreconditioner(precs=tuple(precs))
