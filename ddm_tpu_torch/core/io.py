"""Matrix Market input and output.

Counterpart of ``ddm_tpu/core/io.py`` (the reference reads and writes
Matrix Market in its tests: dune/ddm/test/test_eigensolver.cc loads
A.mtx / B.mtx).  Thin wrappers over ``scipy.io`` on the port's
:class:`EllPattern` and :class:`SparseELL`.
"""

from __future__ import annotations

import io as _io

import scipy.io
import scipy.sparse as sps

from .sparse import EllPattern, SparseELL


def read_matrix_market(source, device) -> tuple[EllPattern, SparseELL]:
    """Read a Matrix Market file, path or string into (pattern, matrix),
    the matrix on ``device`` (named by the caller, as the ``convert.py``
    helpers take it)."""
    if isinstance(source, str) and source.lstrip().startswith("%%MatrixMarket"):
        source = _io.StringIO(source)
    A = sps.csr_matrix(scipy.io.mmread(source))
    coo = A.tocoo()
    pat = EllPattern.from_coo(coo.row, coo.col, A.shape[0])
    return pat, pat.from_scipy_vals(A, device)


def write_matrix_market(path: str, pattern: EllPattern, ell: SparseELL,
                        comment: str = "") -> None:
    scipy.io.mmwrite(path, pattern.to_scipy(ell), comment=comment)
