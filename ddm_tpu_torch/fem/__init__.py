from .grids import Grid, structured_grid  # noqa: F401
