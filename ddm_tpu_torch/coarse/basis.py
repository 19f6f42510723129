"""Coarse-space basis container and finalization.

Counterpart of ``ddm_tpu/coarse/basis.py`` (reference: CoarseSpaceBuilder,
dune/ddm/coarsespaces/coarse_spaces.hh:219-256).  Basis vectors live as one
padded batch ``V[n_sub, nev_max, n_pad]`` in subdomain-local coordinates with
an ``active`` mask in place of the reference's ragged per-rank vectors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class CoarseBasis:
    V: torch.Tensor  # (n_sub, nev_max, n_pad), zero rows where inactive
    active: torch.Tensor  # (n_sub, nev_max) bool
    # True iff every basis vector vanishes on its subdomain's boundary layer
    # (POU-finalized); the pairwise-local Galerkin coarse matrix
    # (precond/galerkin.py) is exact only then
    boundary_vanishing: bool = True

    @property
    def n_sub(self):
        return self.V.shape[0]

    @property
    def nev_max(self):
        return self.V.shape[1]


def finalize_basis(
    V_raw: torch.Tensor, pou: torch.Tensor, valid: torch.Tensor,
    active: torch.Tensor,
) -> CoarseBasis:
    """POU-scale and 2-norm-normalize basis vectors (reference:
    detail::finalize_eigenvectors, coarse_spaces.hh:52-61).  Vectors that
    collapse below 1e-10 of their subdomain's largest are dropped."""
    V = V_raw * pou[:, None, :] * valid[:, None, :]
    norms = torch.sqrt(torch.sum(V * V, dim=2, keepdim=True))
    floor = 1e-10 * torch.amax(norms[:, :, 0], dim=1, keepdim=True)
    active = active & (norms[:, :, 0] > torch.clamp(floor, min=1e-300))
    V = torch.where(active[:, :, None], V / torch.clamp(norms, min=1e-300), 0.0)
    return CoarseBasis(V=V, active=active)
