"""dd_matvec in the PyTorch port: the plain version against the JAX package,
the CUDA kernel against the plain version on a card, one right-hand side
per subdomain and k of them (the multi-RHS ``dd_matmat`` entry, and the
double-single solve over k columns); and torch's ``addcmul`` as the fused
multiply-add that the staged assembly and the SpMV rely on, with the
card's assembled system against the CPU's.

The plain version (the one CPU tensors take) is held against the JAX
package's XLA formula ``ddm_tpu.solvers.direct.dd_matvec`` and its Pallas
kernel run in interpret mode, at the repo's bound of 1e-6 relative
(tests/test_kernels.py): both sides sum f32 products, in different orders.

The ``cuda`` tests skip without a card.  This module imports the JAX package
only inside the tests that compare with it, so on a machine with a card and
no jax the card tests run alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from ddm_tpu_torch.kernels import ddmatvec
from ddm_tpu_torch.solvers.direct import dd_split

from blas_threads import one_blas_thread  # noqa: E402,F401

torch.set_num_threads(2)

# (n_sub, P, q): the two shapes of tests/test_kernels.py and a ragged P
SHAPES = [(4, 256, 200), (2, 640, 640), (3, 177, 177)]
# one-matrix and low-batch shapes, where the launch plan splits the columns
# (the dd coarse solve's (1, 2048, 2048), a ragged one, and small matrices
# whose clusters have 3, 5, 6 and 7 blocks), and the 3-D fine-level sizes
# (n_pad 1000 at overlap 1, 1728 at overlap 2): card tests only
CARD_SHAPES = [(1, 2048, 2048), (1, 1001, 1001), (2, 1536, 1536),
               (1, 12, 12), (1, 37, 37), (1, 24, 24), (1, 100, 100),
               (3, 1000, 1000), (2, 1728, 1728)]
N_SM = 132  # an H100 SXM


def _inputs(n_sub, P, q, seed):
    """(A f64 zero outside the q x q block, d f64 with a wide dynamic
    range), from a numpy seed."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n_sub, P, P))
    A[:, q:, :] = 0
    A[:, :, q:] = 0
    d = rng.standard_normal((n_sub, q)) * 10.0 ** rng.uniform(-6, 6, (n_sub, q))
    return A, d


def _relerr(y, ref):
    y, ref = np.asarray(y), np.asarray(ref)
    return float(np.abs(y - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("n_sub,P,q", SHAPES)
def test_reference_matches_jax(n_sub, P, q):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from ddm_tpu.kernels import dd_matvec_pallas
    from ddm_tpu.solvers.direct import dd_matvec as jax_dd_matvec
    from ddm_tpu.solvers.direct import dd_split as jax_dd_split

    A, d = _inputs(n_sub, P, q, seed=P)
    hi, lo = dd_split(torch.as_tensor(A))
    y = ddmatvec.dd_matvec_reference(hi, lo, torch.as_tensor(d)).numpy()

    hj, lj = jax_dd_split(jnp.asarray(A))
    y_xla = jax_dd_matvec(hj[:, :q, :q], lj[:, :q, :q], jnp.asarray(d))
    assert _relerr(y, y_xla) < 1e-6
    # the Pallas kernel needs 128-aligned zero-padded storage
    P128 = -(-P // 128) * 128
    pad = ((0, 0), (0, P128 - P), (0, P128 - P))
    y_pl = dd_matvec_pallas(jnp.pad(hj, pad), jnp.pad(lj, pad),
                            jnp.asarray(d), interpret=True)
    assert _relerr(y, y_pl) < 1e-6
    # the split itself is the JAX package's, bit for bit
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lj))


@pytest.mark.parametrize("n_sub,P,k", [(3, 64, 3), (2, 37, 9)])
def test_multi_rhs_matches_jax(n_sub, P, k):
    """k right-hand sides at once (the JAX package's ``spq,sqk->spk``
    formula): the plain version against the JAX package's ``dd_matvec`` to
    1e-6 relative (both sum f32 products, in different orders) and column
    by column against the one-column version to 1e-6; the dd solve with two
    exact sparse refinement steps against ``BatchedInverseDD.solve`` of the
    JAX package to 1e-10 relative (the refinement leaves the f32 rounding
    of the last correction only)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from ddm_tpu.solvers.direct import BatchedInverseDD as JaxInverseDD
    from ddm_tpu.solvers.direct import dd_matvec as jax_dd_matvec
    from ddm_tpu.solvers.direct import dd_split as jax_dd_split
    from ddm_tpu_torch.solvers.direct import BatchedInverseDD

    rng = np.random.default_rng(P + k)
    # SPD tridiagonal subdomain matrices (m = 3 sparse slots per row,
    # dummy column P) and their exact inverses
    main = 2.5 + rng.uniform(0, 1, (n_sub, P))
    off = -rng.uniform(0.5, 1, (n_sub, P - 1))
    A = np.zeros((n_sub, P, P))
    idx = np.arange(P)
    A[:, idx, idx] = main
    A[:, idx[1:], idx[:-1]] = off
    A[:, idx[:-1], idx[1:]] = off
    cols = np.stack([idx - 1, idx, idx + 1], -1)
    vals = np.take_along_axis(A, np.clip(cols, 0, P - 1)[None], axis=2)
    outside = (cols < 0) | (cols >= P)
    cols = np.where(outside, P, cols)
    vals = np.where(outside[None], 0.0, vals)
    cols = np.broadcast_to(cols, (n_sub, P, 3)).copy()
    inv = np.linalg.inv(A)
    b = rng.standard_normal((n_sub, P, k)) * 10.0 ** rng.uniform(-3, 3, (n_sub, 1, k))

    hi, lo = dd_split(torch.as_tensor(inv))
    y = ddmatvec.dd_matvec(hi, lo, torch.as_tensor(b)).numpy()
    hj, lj = jax_dd_split(jnp.asarray(inv))
    assert _relerr(y, jax_dd_matvec(hj, lj, jnp.asarray(b))) < 1e-6
    for j in range(k):
        y1 = ddmatvec.dd_matvec(hi, lo, torch.as_tensor(b[..., j])).numpy()
        assert _relerr(y[..., j], y1) < 1e-6

    x = BatchedInverseDD(hi, lo, torch.as_tensor(vals), torch.as_tensor(cols),
                         steps=2).solve(torch.as_tensor(b)).numpy()
    xj = JaxInverseDD(hj, lj, jnp.asarray(vals), jnp.asarray(cols, np.int32),
                      steps=2).solve(jnp.asarray(b))
    assert x.shape == (n_sub, P, k)
    for j in range(k):  # each column to its own scale
        assert _relerr(x[..., j], np.asarray(xj)[..., j]) < 1e-10
        assert _relerr(x[..., j], np.linalg.solve(A, b[..., j, None])[..., 0]) < 1e-10


def _launches():
    return sum(ddmatvec.dd_matvec_cuda.shapes.values())


def _chunk_bounds(pl, q):
    return [(k * pl.cols, min((k + 1) * pl.cols, q)) for k in range(pl.chunks)]


@pytest.mark.parametrize("n_sub,P,q", SHAPES + [(256, 848, 848)] + CARD_SHAPES)
def test_plan_tiles_the_matrix_and_fills_the_card(n_sub, P, q):
    """The kernel's launch plan: column chunks tile [0, q) exactly in whole
    float4s, row tiles cover [0, q), a cluster of at most 8, and at least
    one block per SM wherever q >= 256; the fine shape keeps one chunk."""
    pl = ddmatvec.plan(n_sub, q, N_SM)
    bounds = _chunk_bounds(pl, q)
    assert bounds[0][0] == 0 and bounds[-1][1] == q
    assert all(b0 < b1 for b0, b1 in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert pl.chunks == 1 or pl.cols % 4 == 0
    tiles = -(-q // pl.rows)
    assert (tiles - 1) * pl.rows < q <= tiles * pl.rows
    assert 1 <= pl.chunks <= ddmatvec.MAX_CLUSTER
    assert pl.blocks == n_sub * tiles * pl.chunks
    if q >= 256:
        assert pl.blocks >= N_SM
    if (n_sub, P, q) == (256, 848, 848):
        assert pl == (64, 1, 848, 3584)
    if n_sub == 1 and q <= 100:  # the cluster sizes the card test launches
        assert pl.chunks == {12: 3, 37: 5, 24: 6, 100: 7}[q]


@pytest.mark.parametrize("n_sub,P,q", [(1, 2048, 2048), (1, 1001, 1001)])
def test_chunked_f64_sum_matches_unsplit(n_sub, P, q):
    """The plan's column split changes nothing beyond rounding: the f64
    product of the same hi/lo, summed chunk by chunk in the plan's order,
    against the unsplit f64 product to 1e-14."""
    A, d = _inputs(n_sub, P, q, seed=q)
    hi, lo = dd_split(torch.as_tensor(A))
    A32 = hi.double() + lo.double()
    dt = torch.as_tensor(d)
    pl = ddmatvec.plan(n_sub, q, N_SM)
    assert pl.chunks > 1
    y = torch.zeros(n_sub, q, dtype=torch.float64)
    for c0, c1 in _chunk_bounds(pl, q):
        y += (A32[:, :q, c0:c1] @ dt[:, c0:c1, None])[..., 0]
    assert _relerr(y, (A32 @ dt[..., None])[..., 0]) < 1e-14


def test_dispatch_cpu_takes_reference_and_cuda_wrapper_rejects_cpu():
    A, d = _inputs(2, 64, 50, seed=3)
    hi, lo = dd_split(torch.as_tensor(A))
    dt = torch.as_tensor(d)
    before = _launches()
    y = ddmatvec.dd_matvec(hi, lo, dt)
    assert _launches() == before
    torch.testing.assert_close(
        y, ddmatvec.dd_matvec_reference(hi, lo, dt), rtol=0, atol=0
    )
    with pytest.raises(ValueError):
        ddmatvec.dd_matvec_cuda(hi, lo, dt)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_sub,P,q", SHAPES + CARD_SHAPES)
def test_cuda_kernel_matches_reference(cuda_device, n_sub, P, q):
    """The kernel accumulates in f64: against the plain version (f32
    partial sums) to 1e-6, against the f64 truth to 1e-12."""
    A, d = _inputs(n_sub, P, q, seed=P)
    hi, lo = dd_split(torch.as_tensor(A, device=cuda_device))
    dt = torch.as_tensor(d, device=cuda_device)
    before = _launches()
    y = ddmatvec.dd_matvec(hi, lo, dt)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    ref = ddmatvec.dd_matvec_reference(hi, lo, dt)
    truth = ((hi.double() + lo.double())[:, :q, :q] @ dt[..., None])[..., 0]
    assert _relerr(y.cpu(), ref.cpu()) < 1e-6
    assert _relerr(y.cpu(), truth.cpu()) < 1e-12


@pytest.mark.cuda
def test_cuda_kernel_is_deterministic(cuda_device):
    """The cluster reduction of the column split runs in a fixed order: two
    launches on the same inputs give the same bits."""
    A, d = _inputs(1, 2048, 2048, seed=7)
    hi, lo = dd_split(torch.as_tensor(A, device=cuda_device))
    dt = torch.as_tensor(d, device=cuda_device)
    assert ddmatvec.plan(1, 2048, ddmatvec.sm_count(cuda_device)).chunks > 1
    y1 = ddmatvec.dd_matvec_cuda(hi, lo, dt)
    y2 = ddmatvec.dd_matvec_cuda(hi, lo, dt)
    assert torch.equal(y1, y2)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    A, d = _inputs(2, 64, 64, seed=5)
    hi, lo = dd_split(torch.as_tensor(A, device=cuda_device))
    dt = torch.as_tensor(d, device=cuda_device)
    with pytest.raises(TypeError):
        ddmatvec.dd_matvec_cuda(hi.double(), lo, dt)
    with pytest.raises(ValueError):
        ddmatvec.dd_matvec_cuda(hi.mT, lo, dt)  # not contiguous
    with pytest.raises(ValueError):
        ddmatvec.dd_matvec_cuda(hi, lo, torch.cat([dt, dt], dim=1))  # q > P
    with pytest.raises(ValueError):
        ddmatvec.dd_matvec_cuda(hi, lo, dt[..., None])  # k columns: dd_matmat
    with pytest.raises(ValueError):
        ddmatvec.dd_matmat_cuda(hi, lo, dt)  # one column: dd_matvec


@pytest.mark.cuda
@pytest.mark.parametrize("n_sub,P,k", [(4, 256, 3), (3, 177, 8), (2, 640, 11),
                                       (1, 2048, 8), (8, 848, 8)])
def test_cuda_multi_rhs_kernel_matches_reference(cuda_device, n_sub, P, k):
    """The k-column kernel against the plain version (f32 partial sums) to
    1e-6 and against the f64 product to 1e-12, column by column, with one
    launch per group of up to 8 columns (11 columns: two)."""
    A, _ = _inputs(n_sub, P, P, seed=P + k)
    rng = np.random.default_rng(k)
    d = rng.standard_normal((n_sub, P, k)) * 10.0 ** rng.uniform(-6, 6, (n_sub, P, k))
    hi, lo = dd_split(torch.as_tensor(A, device=cuda_device))
    dt = torch.as_tensor(d, device=cuda_device)
    before = sum(ddmatvec.dd_matmat_cuda.shapes.values())
    y = ddmatvec.dd_matvec(hi, lo, dt)
    torch.cuda.synchronize()
    assert sum(ddmatvec.dd_matmat_cuda.shapes.values()) == before + -(-k // 8)
    ref = ddmatvec.dd_matvec_reference(hi, lo, dt).cpu()
    truth = ((hi.double() + lo.double()) @ dt).cpu()
    for j in range(k):
        assert _relerr(y[..., j].cpu(), ref[..., j]) < 1e-6
        assert _relerr(y[..., j].cpu(), truth[..., j]) < 1e-12


@pytest.mark.cuda
def test_cuda_slice_matches_cpu_f64(cuda_device):
    """The dd slice at islands 32^2/16 on the card (through the kernel)
    against the exact f64 slice on the CPU: iterations within 2, solutions
    within 1e-6, and three kernel launches per fine-level apply."""
    from ddm_tpu_torch import api
    from ddm_tpu_torch.fem import problems

    def run(device, precision):
        pt = api.default_ptree()
        pt["gridsize"] = 32
        pt["solver.reduction"] = 1e-8
        pt["coarsespace.type"] = "geneo"
        pt["geneo.eigensolver.nev"] = 8
        pt["coarse_solver.type"] = "cholesky"
        pt["schwarz.subdomain_solver.precision"] = precision
        p = api.setup_problem(pt, problem=problems.islands(), parts=(4, 4),
                              device=device)
        M = api.build_preconditioner(p)
        ddmatvec.dd_matvec_cuda.shapes.clear()
        res = api.solve(p, M)
        return res, api.solution(p, res).cpu(), _launches(), M

    r_gpu, u_gpu, launches, M = run(cuda_device, "dd")
    r_cpu, u_cpu, _, _ = run("cpu", "f64")
    assert r_gpu.converged and abs(r_gpu.iterations - r_cpu.iterations) <= 2
    assert _relerr(u_gpu, u_cpu) < 1e-6
    assert launches == 3 * M.precs[0].applies > 0


@pytest.mark.cuda
def test_cuda_ring_slice_matches_cpu_f64(cuda_device):
    """The geneo_ring slice at islands 32^2/16 with double-single fine and
    coarse inverses on the card against the exact f64 slice on the CPU:
    iterations within 2, solutions within 1e-6, and three kernel launches
    per fine-level and per coarse-level apply, at their two shapes."""
    from ddm_tpu_torch import api
    from ddm_tpu_torch.fem import problems

    def run(device, precision):
        pt = api.default_ptree()
        pt["gridsize"] = 32
        pt["solver.reduction"] = 1e-8
        pt["solver.verify"] = True
        pt["coarsespace.type"] = "geneo_ring"
        pt["geneo_ring.eigensolver.nev"] = 8
        pt["coarse_solver.type"] = "cholesky"
        pt["schwarz.subdomain_solver.precision"] = precision
        pt["coarse_solver.precision"] = precision
        p = api.setup_problem(pt, problem=problems.islands(), parts=(4, 4),
                              device=device)
        M = api.build_preconditioner(p)
        ddmatvec.dd_matvec_cuda.shapes.clear()
        res = api.solve(p, M)
        return res, api.solution(p, res).cpu(), dict(ddmatvec.dd_matvec_cuda.shapes), M

    r_gpu, u_gpu, shapes, M = run(cuda_device, "dd")
    r_cpu, u_cpu, _, _ = run("cpu", "f64")
    assert r_gpu.converged and abs(r_gpu.iterations - r_cpu.iterations) <= 2
    assert _relerr(u_gpu, u_cpu) < 1e-6
    fine, coarse = M.precs
    n_pad, n_c = fine.sub2glob.shape[1], coarse.V.shape[0] * coarse.V.shape[1]
    assert shapes == {(16, n_pad, n_pad): 3 * fine.applies,
                      (1, n_c, n_c): 3 * coarse.applies}
    assert fine.applies == coarse.applies > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_sub,P", [(4, 1296), (1, 864)])
def test_cuda_kernel_reads_a_nonsymmetric_inverse_by_rows(cuda_device, n_sub, P):
    """LU inverses (the DG paths' subdomain and coarse inverses) are not
    symmetric: at the DG sizes, on a batch whose transpose gives a far
    other product, the kernel matches (hi + lo) @ d to 1e-12 and the
    transposed product not at all."""
    rng = np.random.default_rng(P)
    A = np.tril(rng.standard_normal((n_sub, P, P))) * 3.0 + np.eye(P)
    d = rng.standard_normal((n_sub, P))
    hi, lo = dd_split(torch.as_tensor(A, device=cuda_device))
    dt = torch.as_tensor(d, device=cuda_device)
    y = ddmatvec.dd_matvec_cuda(hi, lo, dt).cpu()
    A32 = (hi.double() + lo.double()).cpu()
    truth = (A32 @ dt.cpu()[..., None])[..., 0]
    wrong = (A32.mT @ dt.cpu()[..., None])[..., 0]
    assert _relerr(y, truth) < 1e-12
    assert _relerr(wrong, truth) > 0.1


def _fma_cases(device):
    """(c, a, b) on ``device`` and the correctly rounded a * b + c, from
    exact rationals: a flat batch whose first half has c = -fl(a * b), so
    the product's rounding error is the whole result (a multiply, then an
    add, gives 0 there), and a broadcast (64, 1) x (1, 64) batch as the
    staged assembly forms its products."""
    from fractions import Fraction

    rng = np.random.default_rng(11)
    n = 4096
    a = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
    b = rng.standard_normal(n)
    c = rng.standard_normal(n)
    c[: n // 2] = -(a[: n // 2] * b[: n // 2])
    cases = [(c, a, b)]
    ab, bb = rng.standard_normal((64, 1)), rng.standard_normal((1, 64))
    cb = -(ab * bb)
    cb[:, ::2] = rng.standard_normal((64, 32))
    cases.append((cb, ab, bb))
    out = []
    for c, a, b in cases:
        aa, bb2 = np.broadcast_arrays(a, b)
        exact = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                          for x, y, z in zip(aa.ravel(), bb2.ravel(),
                                             np.broadcast_to(c, aa.shape).ravel())])
        t = [torch.as_tensor(v, device=device) for v in (c, a, b)]
        out.append((t, exact.reshape(aa.shape)))
    return out


def _addcmul_is_fma(device):
    for (c, a, b), exact in _fma_cases(device):
        y = torch.addcmul(c, a, b).cpu().numpy()
        assert np.array_equal(y, exact), int((y != exact).sum())
        assert not np.array_equal((a * b + c).cpu().numpy(), exact)


def test_addcmul_is_a_fused_multiply_add():
    """torch's ``addcmul`` on the CPU rounds a * b + c once, as the staged
    assembly (fem/assemble.py) and the SpMV (core/sparse.py) need to give
    the JAX package's bits there."""
    _addcmul_is_fma("cpu")


@pytest.mark.cuda
def test_cuda_addcmul_is_a_fused_multiply_add(cuda_device):
    """The same on the card: one rounding, the CPU's bits."""
    _addcmul_is_fma(cuda_device)


@pytest.mark.cuda
def test_cuda_assembly_matches_cpu_bit_for_bit(cuda_device):
    """The staged element matrices, the assembled, constrained system and
    the equilibrated one (its scale taken on the host in numpy's bits) on
    the card give the CPU's bits (which are the JAX package's,
    tests/test_torch_assembly_bitwise.py), islands Q1 32^2; the SpMV of
    the CPU's equilibrated matrix on the card the CPU's bits, fused and
    eager."""
    import dataclasses

    from ddm_tpu_torch.core.sparse import jacobi_equilibrate
    from ddm_tpu_torch.fem import problems
    from ddm_tpu_torch.fem.discretize import Discretization
    from ddm_tpu_torch.fem.grids import structured_grid

    def stages(device):
        d = Discretization(structured_grid((32, 32)), problems.islands(),
                           device)
        Ke, fe = d.element_matrices()
        A, b = d.assemble()
        Ac, rhs, _ = d.constrained_system()
        Ae, be, s = jacobi_equilibrate(Ac, rhs)
        return {"Ke": Ke, "fe": fe, "A": A.vals, "b": b,
                "A_constrained": Ac.vals, "rhs": rhs, "scale": s,
                "A_equilibrated": Ae.vals, "rhs_equilibrated": be}, Ae

    cpu, Ae = stages("cpu")
    card, _ = stages(cuda_device)
    differ = {k: int((cpu[k] != card[k].cpu()).sum()) for k in cpu}
    assert not any(differ.values()), str(differ)
    Ae_card = dataclasses.replace(
        Ae, cols=Ae.cols.to(cuda_device), vals=Ae.vals.to(cuda_device),
        fix_rows=None if Ae.fix_rows is None else Ae.fix_rows.to(cuda_device))
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(Ae.n))
    for fused in (True, False):
        y = Ae_card.mv(v.to(cuda_device), fused=fused).cpu()
        assert torch.equal(y, Ae.mv(v, fused=fused)), fused


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["elasticity_16", "elasticity_bar"])
def test_cuda_slab_assembly_matches_cpu_bit_for_bit(cuda_device, case,
                                                    monkeypatch):
    """The slab-wise element assembly (``DDM_ASSEMBLY_CHUNK``, slabs of 60
    and 100 with padding) on the card gives the CPU's bits, which are the
    JAX package's (tests/test_torch_assembly_slabs.py): the element
    matrices with the slab body's fused multiply-adds, the equilibrated
    system and, for the bar, the SpMV's 81-slot rows in XLA's windows."""
    from ddm_tpu_torch.core.sparse import jacobi_equilibrate
    from ddm_tpu_torch.fem import problems
    from ddm_tpu_torch.fem.discretize import Discretization
    from ddm_tpu_torch.fem.grids import structured_grid

    cells, upper, prob, n_comp, chunk = {
        "elasticity_16": ((16, 16), (3.0, 1.0), "steel_rubber_2d", 2, 60),
        "elasticity_bar": ((12, 4, 6), (10.0, 1.0, 1.5), "steel_rubber_bar",
                           3, 100)}[case]
    monkeypatch.setenv("DDM_ASSEMBLY_CHUNK", str(chunk))
    v = np.random.default_rng(0).standard_normal(
        math.prod(c + 1 for c in cells) * n_comp)

    def stages(device):
        d = Discretization(structured_grid(cells, (0.0,) * len(cells), upper),
                           getattr(problems, prob)(), device, n_comp=n_comp)
        Ke, fe = d.element_matrices()
        Ae, be, _ = jacobi_equilibrate(*d.constrained_system()[:2])
        x = torch.as_tensor(v, device=device)
        return {"Ke": Ke, "fe": fe, "A_equilibrated": Ae.vals,
                "rhs_equilibrated": be, "mv": Ae.mv(x),
                "mv_eager": Ae.mv(x, fused=False)}

    cpu, card = stages("cpu"), stages(cuda_device)
    differ = {k: int((cpu[k] != card[k].cpu()).sum()) for k in cpu}
    assert not any(differ.values()), str(differ)
