"""Runtime-scripted PDE coefficients from a Python file.

Counterpart of ``ddm_tpu/fem/scripted.py`` (reference: the LuaJIT
coefficient scripts, examples/poisson_coefficient.lua etc., evaluated per
quadrature point through LuaProblem, examples/poisson_problems.hh).  The
file defines vectorized torch callables; an example loads it with
``-coefficient_file`` and the functions run inside the assembly on the
problem's device.

The file may define any of ``alpha(x)``, ``b(x)``, ``c(x)``, ``f(x)``,
``g(x)``, ``is_dirichlet(x)`` (vectorized over (..., d) coordinates), or
per-point ``alpha(x, y[, z])`` signatures, which are adapted here.  A
scripted function builds any constant tensor from its argument
(``x.new_tensor``), so that it lives on the argument's device.
"""

from __future__ import annotations

import inspect
import runpy

import torch

from .problems import ElasticityProblem, Problem, steel_rubber_bar


def _stack(parts, xq: torch.Tensor) -> torch.Tensor:
    """(..., len(parts)) field from per-component values (tensors or
    Python numbers, in ``xq``'s dtype) broadcast to ``xq``'s leading
    shape."""
    shape = xq.shape[:-1]
    return torch.stack([torch.broadcast_to(o, shape) if torch.is_tensor(o)
                        else xq.new_full(shape, o) for o in parts], dim=-1)


def _adapt(fn, vector_valued=False):
    """Accept either vectorized f(coords) or per-point f(x, y[, z])."""
    n_args = len(inspect.signature(fn).parameters)
    if n_args == 1:
        return fn

    def wrapped(xq):
        out = fn(*(xq[..., i] for i in range(n_args)))
        if vector_valued and isinstance(out, (tuple, list)):
            return _stack(out, xq)
        return out

    return wrapped


def load_problem(path: str, name: str | None = None) -> Problem:
    """Scalar problem from the script at ``path``; a convection field
    comes as ``b`` or as its components ``b1`` and ``b2`` and makes the
    problem nonsymmetric."""
    ns = runpy.run_path(path)
    kwargs = {"name": name or path}
    for key in ("alpha", "f", "g", "c", "is_dirichlet"):
        if key in ns:
            kwargs[key] = _adapt(ns[key])
    if "b" in ns:
        kwargs["b"] = _adapt(ns["b"], vector_valued=True)
        kwargs["symmetric"] = False
    elif "b1" in ns and "b2" in ns:
        b1, b2 = _adapt(ns["b1"]), _adapt(ns["b2"])
        kwargs["b"] = lambda xq: _stack((b1(xq), b2(xq)), xq)
        kwargs["symmetric"] = False
    return Problem(**kwargs)


def load_elasticity_problem(path: str,
                            name: str | None = None) -> ElasticityProblem:
    """Elasticity coefficients from the script at ``path`` (the analogue of
    the reference's coefficient.lua for linearelasticity.cc): ``lam`` and
    ``mu``, or ``youngs_modulus`` and ``poisson_ratio``, from which the
    Lame parameters follow as coefficient.lua:62-72 derives them; ``f``,
    ``g`` and ``is_dirichlet`` default to :func:`steel_rubber_bar`'s."""
    ns = runpy.run_path(path)
    default = steel_rubber_bar()
    if "lam" in ns and "mu" in ns:
        lam, mu = _adapt(ns["lam"]), _adapt(ns["mu"])
    elif "youngs_modulus" in ns and "poisson_ratio" in ns:
        E_fn = _adapt(ns["youngs_modulus"])
        nu_fn = _adapt(ns["poisson_ratio"])

        def lam(xq):
            E, nu = E_fn(xq), nu_fn(xq)
            return E * nu / (1.0 + nu) / (1.0 - 2.0 * nu)

        def mu(xq):
            E, nu = E_fn(xq), nu_fn(xq)
            return E / 2.0 / (1.0 + nu)
    else:
        raise KeyError(
            f"{path}: elasticity coefficient file must define lam/mu or "
            "youngs_modulus/poisson_ratio"
        )
    return ElasticityProblem(
        lam=lam,
        mu=mu,
        f=_adapt(ns["f"], vector_valued=True) if "f" in ns else default.f,
        g=_adapt(ns["g"], vector_valued=True) if "g" in ns else default.g,
        is_dirichlet=(_adapt(ns["is_dirichlet"]) if "is_dirichlet" in ns
                      else default.is_dirichlet),
        name=name or path,
    )
