from .ddmatvec import dd_matvec, dd_matvec_cuda, dd_matvec_reference  # noqa: F401
