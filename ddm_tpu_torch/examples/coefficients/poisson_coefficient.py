# Torch counterpart of ddm_tpu/examples/coefficients/poisson_coefficient.py,
# the Python analogue of the reference's poisson_coefficient.lua: the
# islands coefficient as a script, loaded at run time through
# -coefficient_file (ddm_tpu_torch/fem/scripted.py).  Same constants and
# order of operations as the JAX file.
import torch


def g(x, y):
    return 1.0 - x


def f(x, y):
    return torch.zeros_like(x)


def alpha(x, y):
    kappa = torch.ones_like(x)
    kappa = torch.where(
        (x > 0.3) & (x < 0.9) & (y > 0.6 - (x - 0.3) / 6)
        & (y < 0.8 - (x - 0.3) / 6),
        1e5 * (x + y) * 10.0, kappa)
    kappa = torch.where(
        (x > 0.1) & (x < 0.5) & (y > 0.1 + x) & (y < 0.25 + x),
        1e5 * (1.0 + 7.0 * y), kappa)
    kappa = torch.where(
        (x > 0.5) & (x < 0.9) & (y > 0.15 - (x - 0.5) * 0.25)
        & (y < 0.35 - (x - 0.5) * 0.25),
        torch.full_like(x, 1e5 * 2.5), kappa)
    ix = torch.floor(15.0 * x).to(torch.int32)
    iy = torch.floor(15.0 * y).to(torch.int32)
    kappa = torch.where((ix % 2 == 0) & (iy % 2 == 0),
                        1e5 * (1.0 + ix.to(x.dtype) + iy.to(x.dtype)), kappa)
    return kappa


def is_dirichlet(x, y):
    return (x < 1e-6) | (x > 1.0 - 1e-6)
