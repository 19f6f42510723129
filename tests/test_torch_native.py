"""The port's native (g++/ctypes) host topology: the loader builds, the
native route gives every array of the scipy route on structured 2-D and
3-D grids and on the generated L-shape, both equal the JAX package's
topology, and the routes are counted."""

from pathlib import Path

import numpy as np
import pytest
import torch

from ddm_tpu.core import indexmaps as jidx
from ddm_tpu_torch import _native
from ddm_tpu_torch.core import indexmaps as tidx
from ddm_tpu_torch.core.setup import partition_elements, topology_inputs
from ddm_tpu_torch.fem import problems
from ddm_tpu_torch.fem.discretize import Discretization
from ddm_tpu_torch.fem.grids import Grid, refine, structured_grid

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)


def _inputs(grid, n_sub=None, parts=None):
    """``build_topology``'s inputs for islands on ``grid``, as
    ``setup_problem`` builds them."""
    disc = Discretization(grid, problems.islands(), torch.device("cpu"))
    return topology_inputs(
        disc, partition_elements(disc, n_sub=n_sub, parts=parts))


def _lshape(cells=22):
    """The L-shape [0,1]^2 minus (0.5,1]^2: the triangles of a cells x
    cells simplex grid outside the removed quadrant, the nodes no triangle
    uses dropped."""
    g = structured_grid((cells, cells), simplex=True)
    c = g.elem_centroids()
    tris = g.elems[~((c[:, 0] > 0.5) & (c[:, 1] > 0.5))]
    used, elems = np.unique(tris, return_inverse=True)
    return Grid(nodes=g.nodes[used], elems=elems.reshape(tris.shape),
                elem_type="tri")

SCALARS = ("n_glob", "n_sub", "n_pad", "overlap", "bdist_cap")
ARRAYS = ("sub2glob", "valid", "owner", "boundary", "bdist", "dof_owner",
          "g2l_keys", "g2l_locs", "sizes")


def _assert_same(a, b):
    for f in SCALARS:
        assert getattr(a, f) == getattr(b, f), f
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert (a.membership != b.membership).nnz == 0


def _native_equals_python(adj, M0, owner, overlap):
    native = tidx.build_topology(adj, M0, owner, overlap, use_native=True)
    python = tidx.build_topology(adj, M0, owner, overlap, use_native=False)
    _assert_same(native, python)
    return native


def test_native_builds_and_loads():
    lib = _native.build()
    assert lib == _native.LIB and lib.exists()
    assert lib.parent.parts[-2:] == ("build", "ddm_tpu_torch")
    assert _native.load() is not None


@pytest.mark.parametrize("overlap", [1, 2, 3])
def test_native_equals_python_2d(overlap):
    adj, M0, owner = _inputs(structured_grid((20, 20)), parts=(2, 2))
    _native_equals_python(adj, M0, owner, overlap)


def test_native_equals_python_lshape():
    """The L-shape of 22 x 22 cells, refined once, 8 RCB subdomains,
    overlap 2."""
    adj, M0, owner = _inputs(refine(_lshape(), 1), n_sub=8)
    t = _native_equals_python(adj, M0, owner, 2)
    assert t.n_sub == 8


def test_native_equals_python_3d():
    adj, M0, owner = _inputs(structured_grid((6, 6, 6)), parts=(2, 2, 2))
    _native_equals_python(adj, M0, owner, 2)


def test_native_equals_jax_topology():
    """Islands 20^2 / (2, 2), overlap 2: the port's native topology equals
    the JAX package's on its native and its scipy route."""
    adj, M0, owner = _inputs(structured_grid((20, 20)), parts=(2, 2))
    t = tidx.build_topology(adj, M0, owner, 2, use_native=True)
    for use_native in (True, False):
        _assert_same(t, jidx.build_topology(adj, M0, owner, 2,
                                            use_native=use_native))


def test_ddmcore_source_is_the_jax_copy():
    def body(path):
        lines = path.read_text().splitlines()
        first = next(i for i, s in enumerate(lines) if not s.startswith("//"))
        return lines[first:]

    assert body(_native.SRC) == body(ROOT / "ddm_tpu/_native/ddmcore.cpp")


def test_routes_counted(monkeypatch):
    """The default takes the native route and ``use_native=False`` the
    scipy route; when the library is unavailable the default falls back to
    the scipy route and ``use_native=True`` raises."""
    adj, M0, owner = _inputs(structured_grid((8, 8)), parts=(2, 2))
    before = dict(tidx.TOPOLOGY_ROUTES)

    def taken():
        return {k: tidx.TOPOLOGY_ROUTES[k] - before[k] for k in before}

    tidx.build_topology(adj, M0, owner, 1)
    assert taken() == {"native": 1, "python": 0}
    tidx.build_topology(adj, M0, owner, 1, use_native=False)
    assert taken() == {"native": 1, "python": 1}
    monkeypatch.setattr(_native, "load", lambda: None)
    monkeypatch.setattr(_native, "error", "g++ failed")
    tidx.build_topology(adj, M0, owner, 1)
    assert taken() == {"native": 1, "python": 2}
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tidx.build_topology(adj, M0, owner, 1, use_native=True)


def test_failed_build_warns_once(monkeypatch, capsys):
    """A build that fails leaves ``load()`` returning None with the reason
    in ``error``, warns once on stderr, and is not tried again."""
    calls = []

    def failing_build():
        calls.append(1)
        raise RuntimeError("g++ failed for ddmcore.cpp")

    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "error", None)
    monkeypatch.setattr(_native, "build", failing_build)
    assert _native.load() is None and _native.load() is None
    assert calls == [1]
    assert _native.error == "g++ failed for ddmcore.cpp"
    warned = [s for s in capsys.readouterr().err.splitlines()
              if s.startswith("[warn]")]
    assert len(warned) == 1 and "scipy route" in warned[0]
