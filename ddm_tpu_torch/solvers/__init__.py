from .direct import BatchedCholesky, BatchedInverse, BatchedInverseDD, factor_batched  # noqa: F401
from .krylov import KrylovResult, bicgstab_solve, cg_solve, gmres_solve  # noqa: F401
from .newton import NewtonResult, newton_from_config, newton_solve  # noqa: F401
