"""Extraction of dense subdomain matrices, subdomain gathers and scatters.

Counterpart of ``ddm_tpu/precond/extract.py`` (general path).  Row p of
subdomain k is global row ``sub2glob[k, p]`` with the entries whose columns
fall outside the subdomain dropped — the overlapping "Dirichlet" matrix
A_dir of the reference (examples/pdelab_helper.hh:134-138).

The scatter-add back to global dofs goes through the fixed-order gather-dual
map (core/indexmaps.py:dual_scatter_map), so the sum over the subdomains
sharing a dof is taken in the same order on every run — GPU atomics are not.
"""

from __future__ import annotations

import torch

from ..core.sparse import SparseELL


def extract_subdomain_dense(
    ell: SparseELL,
    sub2glob: torch.Tensor,  # (n_sub, n_pad) int64, pad == n_glob
    valid: torch.Tensor,  # (n_sub, n_pad) bool
    local_cols: torch.Tensor,  # (n_sub, n_pad, m) int64, dummy == n_pad
    unit_padding_diag: bool = True,
) -> torch.Tensor:
    """Returns A_sub (n_sub, n_pad, n_pad) dense; padding rows/cols are
    zero except a unit diagonal (so the batch factors cleanly).

    Within a row every kept column is distinct, so the placement is a plain
    scatter (no sums); dropped entries all land in the dump column n_pad,
    which is cut off."""
    n_sub, n_pad = sub2glob.shape
    rows = torch.clamp(sub2glob, max=ell.n - 1)
    vals, _ = ell.rows_dense_gather(rows)  # (n_sub, n_pad, m)
    vals = vals * valid[:, :, None]
    A = vals.new_zeros((n_sub, n_pad, n_pad + 1))
    A.scatter_(2, local_cols, vals)
    A = A[..., :n_pad]
    if unit_padding_diag:
        A = A + torch.diag_embed((~valid).to(A.dtype))
    return A


def gather_subdomain(x: torch.Tensor, sub2glob: torch.Tensor) -> torch.Tensor:
    """Global (n,) or (n, k) -> subdomain-local (n_sub, n_pad[, k]); padding
    slots read 0 (reference: copyOwnerToAll restriction, schwarz.hh:122-125)."""
    xp = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    return xp[sub2glob]


def scatter_add_subdomain(x_sub: torch.Tensor, dualT: torch.Tensor) -> torch.Tensor:
    """Subdomain-local (n_sub, n_pad[, k]) -> global (n[, k]) by summation
    over the (K, n) gather-dual map (reference: addOwnerCopyToOwnerCopy,
    schwarz.hh:138-142)."""
    trail = x_sub.shape[2:]
    flat = torch.cat([x_sub.reshape((-1,) + trail),
                      x_sub.new_zeros((1,) + trail)])
    return flat[dualT].sum(dim=0)
