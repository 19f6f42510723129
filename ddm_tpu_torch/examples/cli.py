"""Unified example command line (reference: examples/pdelab_example.cc:
29-241).

Counterpart of ``ddm_tpu/examples/cli.py``: ``-problem`` picks the example,
the other arguments (``-ini_file``, ``-key value`` overrides) go to its
``main``.  Runs on the CUDA card unless ``device="cpu"`` is passed:

    python -m ddm_tpu_torch.examples.cli -problem poisson -ini_file \\
        ddm_tpu_torch/examples/configs/poisson.ini -solver.reduction 1e-10

``poisson`` (the problem from the ini, else ``simple``),
``convection_diffusion`` (``checkerboard_cd``), ``islands`` and ``beams``
run the Poisson example; ``dg`` / ``convection_diffusion_dg`` the DG
example; ``elasticity`` / ``linear_elasticity`` the elasticity example;
``nonlinear_poisson`` / ``nonlinear`` the Newton example.  The first
``-problem`` is consumed here: a second one reaches the Poisson example as
its ``problem`` key.
"""

from __future__ import annotations

import sys


def main(argv=None, device=None):
    """Dispatch on ``-problem`` (default poisson); returns what the
    example's ``main`` returns.  An unknown name raises ``SystemExit``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    problem = "poisson"
    if "-problem" in argv:
        i = argv.index("-problem")
        problem = argv[i + 1]
        del argv[i : i + 2]

    if problem in ("poisson", "convection_diffusion", "islands", "beams"):
        from .poisson import main as m

        if problem == "convection_diffusion":
            argv += ["-problem", "checkerboard_cd"]
        elif problem in ("islands", "beams"):
            argv += ["-problem", problem]
    elif problem in ("convection_diffusion_dg", "dg"):
        from .convectiondiffusiondg import main as m
    elif problem in ("elasticity", "linear_elasticity"):
        from .linearelasticity import main as m
    elif problem in ("nonlinear_poisson", "nonlinear"):
        from .nonlinearpoisson import main as m
    else:
        raise SystemExit(f"Unknown problem '{problem}'")
    return m(argv, device)


if __name__ == "__main__":
    main()
