from .sparse import EllPattern, SparseELL, SumPlan  # noqa: F401
