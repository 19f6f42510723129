"""The port's slab-wise element assembly against the JAX package's, bit for
bit, on the CPU.

Above about 8.4M gradient entries (``fem/assemble.py:_elem_chunk``) both
packages assemble the element batch in slabs: the coefficients over the
whole batch, the geometry and element terms per slab, the last slab
padded by repeating the last element.  The JAX package runs the slabs
through ``lax.map``, one compiled body, in which XLA fuses elasticity's
strain sum into a fused multiply-add; the port forms that sum with
``torch.addcmul`` there.  Each case forces slabs at a small size through
``DDM_ASSEMBLY_CHUNK`` (a slab size that is not a multiple of 8 and
leaves padding) and holds every stage of the assembled system to the JAX
package's with ``np.array_equal``, as ``test_torch_assembly_bitwise.py``
does.  A last case holds the port's slab rule to the JAX package's at the
full sizes of ``chip_smoke.py``'s paths.
"""

import contextlib
import os
import types

import numpy as np
import pytest
import torch

from ddm_tpu.fem import assemble as jassemble
from ddm_tpu.fem import problems as jproblems
from ddm_tpu.fem.discretize import Discretization as JDiscretization
from ddm_tpu.fem.grids import structured_grid as j_grid
from ddm_tpu_torch.fem import assemble as tassemble
from ddm_tpu_torch.fem import problems as tproblems
from ddm_tpu_torch.fem.discretize import Discretization as TDiscretization
from ddm_tpu_torch.fem.grids import structured_grid as t_grid

from blas_threads import one_blas_thread  # noqa: E402,F401
from test_torch_assembly_bitwise import _np, system_stages  # noqa: E402

torch.set_num_threads(2)

# name -> (cells, box upper corner, problem, n_comp, slab size)
CASES = {
    # 216 hexes in 5 slabs of 50, 34 of them padding
    "hex_islands_6": ((6, 6, 6), None, "islands", 1, 50),
    # 256 quads in 5 slabs of 60, 44 padding
    "elasticity_16": ((16, 16), (3.0, 1.0), "steel_rubber_2d", 2, 60),
    # the steel-rubber bar, 288 hexes in 3 slabs of 100, 12 padding
    "elasticity_bar": ((12, 4, 6), (10.0, 1.0, 1.5), "steel_rubber_bar", 3,
                       100),
}

# case -> {stage: the largest relative difference measured on the CPU};
# every other stage is bit-equal
NOT_BIT_EQUAL = {}


@contextlib.contextmanager
def _slabs(chunk):
    """``DDM_ASSEMBLY_CHUNK`` set to ``chunk`` (None: unset) for the
    block; both packages read it at each assembly call."""
    old = os.environ.pop("DDM_ASSEMBLY_CHUNK", None)
    if chunk is not None:
        os.environ["DDM_ASSEMBLY_CHUNK"] = str(chunk)
    try:
        yield
    finally:
        os.environ.pop("DDM_ASSEMBLY_CHUNK", None)
        if old is not None:
            os.environ["DDM_ASSEMBLY_CHUNK"] = old


def _stages(name):
    cells, upper, prob, n_comp, chunk = CASES[name]
    lower = (0.0,) * len(cells) if upper else None
    dj = JDiscretization(j_grid(cells, lower, upper),
                         getattr(jproblems, prob)(), n_comp=n_comp)
    dt = TDiscretization(t_grid(cells, lower, upper),
                         getattr(tproblems, prob)(), "cpu", n_comp=n_comp)
    with _slabs(chunk):
        return system_stages(dj, dt)


@pytest.mark.parametrize("name", list(CASES))
def test_slab_assembly_is_bit_equal_to_jax(name):
    loose = NOT_BIT_EQUAL.get(name, {})
    for stage, (a, b) in _stages(name).items():
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (stage, a.shape, b.shape)
        if stage in loose:
            rel = float(np.abs(a - b).max() / np.abs(a).max())
            assert rel <= loose[stage], (stage, rel)
        else:
            assert np.array_equal(a, b), (
                stage, int((a != b).sum()), a.size,
                float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)))


def test_slabs_change_the_elasticity_bits_as_in_jax():
    """The slab body's fused strain sum moves the last bits of the
    elasticity element matrices on a structured grid, where the Jacobians
    are diagonal (so the case above tests the slab path, not the one-shot
    one), and leaves the loads as they were."""
    cells, upper, prob, n_comp, chunk = CASES["elasticity_16"]
    d = TDiscretization(t_grid(cells, (0.0, 0.0), upper),
                        getattr(tproblems, prob)(), "cpu", n_comp=n_comp)
    p = d.problem
    with _slabs(0):
        one = tassemble.assemble_linear_elasticity(d.quad, d.xe, p.lam, p.mu,
                                                   p.f)
    with _slabs(chunk):
        slab = tassemble.assemble_linear_elasticity(d.quad, d.xe, p.lam,
                                                    p.mu, p.f)
    assert not torch.equal(one[0], slab[0])
    assert torch.equal(one[1], slab[1])


def _coefficients(lib, stack, elastic, convection):
    """Coefficient callables of one package (``lib`` its array module):
    Lame parameters and a load, or a diffusion, convection, reaction and
    source term, each varying in space."""
    def vec(p):
        return stack([p[..., 1], -p[..., 0]] + list(p.unbind(-1)[2:])
                     if lib is torch else
                     [p[..., 1], -p[..., 0]] + [p[..., k] for k in
                                                range(2, p.shape[-1])], -1)

    if elastic:
        return (lambda p: 1.0 + p[..., 0] ** 2, lambda p: 2.0 + p[..., 1],
                vec)
    return (lambda p: 1.0 + p[..., 0] ** 2, vec if convection else None,
            lambda p: 3.0 + p[..., 1] if convection else None,
            lambda p: p[..., 0] + 2.0)


# element type, simplices, cells, elasticity (else convection-diffusion
# with a convection and a reaction term); every node moved at random
JITTERED = {"hex_convection": ("hex", False, (6, 6, 6), False),
            "tri_convection": ("tri", True, (16, 16), False),
            "quad_elasticity": ("quad", False, (16, 16), True),
            "hex_elasticity": ("hex", False, (6, 6, 6), True)}
# the largest relative difference measured on the CPU, not reproduced
# yet: XLA sums the loads of the last two triangles of a slab of 50 (a
# slab size 2 mod 4) in an order of their own (10 of 1,536 loads), and the
# hex reaction term of the last elements of a slab whose size is not a
# multiple of 8, as it does in one shot (10 of 13,824 matrix entries)
JITTERED_NOT_BIT_EQUAL = {"tri_convection": {"fe": 1.56e-16},
                          "hex_convection": {"Ke": 1.18e-17}}


@pytest.mark.parametrize("name", list(JITTERED))
def test_slab_body_on_moved_nodes_is_bit_equal_to_jax(name):
    """The slab body's fused multiply-adds (the Jacobian's adjugate and
    determinant, elasticity's strain sum) on elements whose Jacobians are
    full, in slabs of 50 with padding."""
    import jax.numpy as jnp

    elem, simplex, cells, elastic = JITTERED[name]
    g = j_grid(cells, simplex=simplex)
    x = np.asarray(g.nodes)[np.asarray(g.elems)]
    x = x + np.random.default_rng(3).uniform(-0.15, 0.15, x.shape) / cells[0]
    with _slabs(50):
        if elastic:
            j = jassemble.assemble_linear_elasticity(
                jassemble.ElementQuadrature(elem), jnp.asarray(x),
                *_coefficients(jnp, jnp.stack, True, False))
            t = tassemble.assemble_linear_elasticity(
                tassemble.ElementQuadrature(elem, "cpu"), torch.as_tensor(x),
                *_coefficients(torch, torch.stack, True, False))
        else:
            j = jassemble.assemble_convection_diffusion(
                jassemble.ElementQuadrature(elem), jnp.asarray(x),
                *_coefficients(jnp, jnp.stack, False, True))
            t = tassemble.assemble_convection_diffusion(
                tassemble.ElementQuadrature(elem, "cpu"), torch.as_tensor(x),
                *_coefficients(torch, torch.stack, False, True))
    loose = JITTERED_NOT_BIT_EQUAL.get(name, {})
    for stage, a, b in zip(("Ke", "fe"), j, t):
        a, b = np.asarray(a), b.numpy()
        if stage in loose:
            rel = float(np.abs(a - b).max() / np.abs(a).max())
            assert rel <= loose[stage], (stage, rel, int((a != b).sum()))
        else:
            assert np.array_equal(a, b), (stage, int((a != b).sum()), a.size)


# the element batches of chip_smoke.py's full-size paths: (element type,
# elements, nodes, dimension, elasticity) -> the slab size of both packages
FULL_SIZE_SLABS = {
    "elast_f64 / elast_dd, steel-rubber 256^2": (("quad", 256**2, 4, 2, True),
                                                 16384),
    "hex_ov1 / hex_ov2, islands 56^3": (("hex", 56**3, 8, 3, False), 21845),
    "elast3d, the bar 80 x 8 x 12": (("hex", 80 * 8 * 12, 8, 3, True), 1024),
    "islands 384^2": (("quad", 384**2, 4, 2, False), None),
    "P2 islands 192^2": (("tri2", 2 * 192**2, 6, 2, False), None),
    "DG 192^2": (("quad", 192**2, 4, 2, False), None),
}


@pytest.mark.parametrize("name", list(FULL_SIZE_SLABS))
def test_slab_rule_matches_jax_at_full_size(name, monkeypatch):
    monkeypatch.delenv("DDM_ASSEMBLY_CHUNK", raising=False)
    (elem, n_e, nd, d, elastic), expected = FULL_SIZE_SLABS[name]
    xe = types.SimpleNamespace(shape=(n_e, nd, d))
    factor = nd * d if elastic else 1
    j = jassemble._elem_chunk(jassemble.ElementQuadrature(elem), xe, factor)
    t = tassemble._elem_chunk(tassemble.ElementQuadrature(elem, "cpu"), xe,
                              factor)
    assert j == t == expected
    for env in ("0", str(n_e), "1000"):
        monkeypatch.setenv("DDM_ASSEMBLY_CHUNK", env)
        assert (jassemble._elem_chunk(jassemble.ElementQuadrature(elem), xe,
                                      factor)
                == tassemble._elem_chunk(
                    tassemble.ElementQuadrature(elem, "cpu"), xe, factor))
