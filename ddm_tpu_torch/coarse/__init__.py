from .basis import CoarseBasis, finalize_basis  # noqa: F401
