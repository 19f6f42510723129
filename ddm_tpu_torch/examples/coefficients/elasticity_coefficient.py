# Torch counterpart of ddm_tpu/examples/coefficients/elasticity_coefficient.py,
# the Python port of the reference's coefficient.lua: steel-reinforced
# rubber, a 2x4 pattern of cylindrical steel bars (E=2e11, nu=0.3) along x
# in [0,3] inside a rubber bar (E=2e7, nu=0.45), clamped at x=0.  Loaded
# through -coefficient_file (ddm_tpu_torch/fem/scripted.py:
# load_elasticity_problem derives the Lame parameters from
# youngs_modulus / poisson_ratio as the lua script does).  The bar
# positions are made from the argument (x.new_tensor), so they live on the
# device of the quadrature points.
import torch

BAR_RADIUS = 0.04
BAR_START_X = 0.0
BAR_END_X = 3.0
BAR_POSITIONS_Y = (0.25, 0.75)
BAR_POSITIONS_Z = (0.3, 0.6, 0.9, 1.2)

STEEL_YOUNGS_MODULUS = 2e11
STEEL_POISSON_RATIO = 0.3
RUBBER_YOUNGS_MODULUS = 2e7
RUBBER_POISSON_RATIO = 0.45


def _is_inside_steel_bar(x, y, z):
    bars_y = x.new_tensor(BAR_POSITIONS_Y)
    bars_z = x.new_tensor(BAR_POSITIONS_Z)
    d2 = (y[..., None, None] - bars_y[:, None]) ** 2 + (
        z[..., None, None] - bars_z[None, :]
    ) ** 2
    inside_r = (d2 <= BAR_RADIUS**2).any(dim=-1).any(dim=-1)
    return inside_r & (x >= BAR_START_X) & (x <= BAR_END_X)


def youngs_modulus(x, y, z):
    return torch.where(_is_inside_steel_bar(x, y, z),
                       torch.full_like(x, STEEL_YOUNGS_MODULUS),
                       torch.full_like(x, RUBBER_YOUNGS_MODULUS))


def poisson_ratio(x, y, z):
    return torch.where(_is_inside_steel_bar(x, y, z),
                       torch.full_like(x, STEEL_POISSON_RATIO),
                       torch.full_like(x, RUBBER_POISSON_RATIO))


def is_dirichlet(x, y, z):
    return x < 1e-9
