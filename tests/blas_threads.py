"""One BLAS thread for a test module of the port.

``from blas_threads import one_blas_thread  # noqa: F401`` in a test
module runs the whole module with numpy's and scipy's OpenBLAS (which the
JAX package's CPU LAPACK calls reach too) on one thread, and so do the
processes it forks.  The suite runs on six workers: with each worker's
BLAS on every core, the workers' threads oversubscribed the cores several
times over, and the forked bench baselines more still.  The module's
results are those of one BLAS thread, on both packages' sides.
"""

import pytest


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # a card's host without it runs the module as is
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield
