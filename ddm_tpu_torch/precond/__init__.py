from .schwarz import SchwarzPreconditioner, build_schwarz  # noqa: F401
