from .logger import Logger, ScopedLog, scoped  # noqa: F401
