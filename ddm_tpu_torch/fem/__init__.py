from .grids import Grid, structured_grid  # noqa: F401
from .highorder import p2_dofs  # noqa: F401
from .nonlinear import NonlinearDiscretization, NonlinearProblem  # noqa: F401
