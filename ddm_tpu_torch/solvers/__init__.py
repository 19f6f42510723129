from .direct import BatchedCholesky, BatchedInverse, BatchedInverseDD, factor_batched  # noqa: F401
from .krylov import KrylovResult, cg_solve, gmres_solve  # noqa: F401
