"""POU (Nicolaides-type) coarse space.

Counterpart of ``ddm_tpu/coarse/pou_space.py`` (reference: POUCoarseSpace,
coarse_spaces.hh:1175-1231): basis = partition of unity times template
vectors (default: the constant-1 vector, the classic Nicolaides coarse
space), POU-finalized.  For elasticity the templates are the rigid-body
modes, the near-kernel of the elastic operator.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.indexmaps import DDMTopology
from ..precond.extract import gather_subdomain
from .basis import CoarseBasis, finalize_basis


def pou_coarse_space(
    topo: DDMTopology,
    pou: np.ndarray,
    templates: list | None = None,
    dirichlet_mask: torch.Tensor | None = None,
    *,
    device,
) -> CoarseBasis:
    """templates: list of global (n,) vectors (numpy or tensors); default
    [ones].  They are zeroed at Dirichlet dofs (reference:
    make_zero_at_dirichlet, twolevel_schwarz.hh:47-55): coarse directions
    must live in the constrained space."""
    if templates is None:
        templates = [np.ones(topo.n_glob)]
    T = torch.stack([torch.as_tensor(t, dtype=torch.float64, device=device)
                     for t in templates])  # (nev, n)
    if dirichlet_mask is not None:
        T = torch.where(dirichlet_mask.to(device)[None, :], 0.0, T)
    sub2glob = torch.as_tensor(topo.sub2glob.astype(np.int64), device=device)
    # (n, nev) -> (n_sub, n_pad, nev) -> (n_sub, nev, n_pad)
    V_raw = gather_subdomain(T.T, sub2glob).permute(0, 2, 1)
    active = torch.ones((topo.n_sub, len(templates)), dtype=torch.bool,
                        device=device)
    return finalize_basis(
        V_raw, torch.as_tensor(pou, dtype=torch.float64, device=device),
        torch.as_tensor(topo.valid, device=device), active,
    )


def rigid_body_modes(nodes: np.ndarray, n_comp: int) -> list:
    """Global rigid-body-mode template vectors (host numpy): translations
    and linearized rotations, 3 modes in 2-D, 6 in 3-D.  Dof layout:
    node-major, component-minor."""
    n, d = nodes.shape
    if n_comp != d:
        raise ValueError(f"rigid-body modes need n_comp == dim ({n_comp}, {d})")
    x = nodes
    zero = np.zeros(n)
    fields = []
    for c in range(d):
        t = np.zeros((n, d))
        t[:, c] = 1.0
        fields.append(t)
    if d == 2:
        fields.append(np.stack([-x[:, 1], x[:, 0]], axis=1))
    else:
        fields += [np.stack([-x[:, 1], x[:, 0], zero], axis=1),
                   np.stack([-x[:, 2], zero, x[:, 0]], axis=1),
                   np.stack([zero, -x[:, 2], x[:, 1]], axis=1)]
    return [np.ascontiguousarray(f.reshape(-1)) for f in fields]
