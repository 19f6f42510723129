# Torch counterpart of
# ddm_tpu/examples/coefficients/convection_diffusion_coefficient.py, the
# Python port of the reference's convection_diffusion_coefficient.lua:
# 8x8 checkerboard diffusion (1e-6 / 1), constant wind b = (1/3, 1),
# inflow Dirichlet on the left/bottom edges, g = 1 on the left edge.
# Loaded through -coefficient_file (ddm_tpu_torch/fem/scripted.py adapts
# the per-point (x, y) signatures into vectorized functions).
import torch


def alpha(x, y):
    nx, ny = 8, 8
    a1, a2 = 1e-6, 1.0
    ix = torch.floor(x * nx).to(torch.int32)
    iy = torch.floor(y * ny).to(torch.int32)
    return torch.where(ix % 2 == iy % 2, torch.full_like(x, a2),
                       torch.full_like(x, a1))


def f(x, y):
    return torch.zeros_like(x)


def is_dirichlet(x, y):
    return (x < 1e-6) | (y < 1e-6)


def b1(x, y):
    return torch.full_like(x, 1.0 / 3.0)


def b2(x, y):
    return torch.ones_like(x)


def g(x, y):
    return torch.where(x < 1e-6, torch.ones_like(x), torch.zeros_like(x))
