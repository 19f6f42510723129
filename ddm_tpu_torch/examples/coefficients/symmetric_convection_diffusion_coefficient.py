# Torch counterpart of
# ddm_tpu/examples/coefficients/symmetric_convection_diffusion_coefficient.py,
# the Python port of the reference's
# symmetric_convection_diffusion_coefficient.lua: unit diffusion, unit
# source, Dirichlet on the left (x = 0) and top (y = 1) edges, g = 0.
# Loaded through -coefficient_file (ddm_tpu_torch/fem/scripted.py).
import torch


def alpha(x, y):
    return torch.ones_like(x)


def f(x, y):
    return torch.ones_like(x)


def is_dirichlet(x, y):
    return (torch.abs(x) < 1e-6) | (torch.abs(1.0 - y) < 1e-6)


def g(x, y):
    return torch.zeros_like(x)
