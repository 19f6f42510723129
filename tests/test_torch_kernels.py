"""dd_matvec in the PyTorch port: the plain version against the JAX package,
the CUDA kernel against the plain version on a card.

The plain version (the one CPU tensors take) is held against the JAX
package's XLA formula ``ddm_tpu.solvers.direct.dd_matvec`` and its Pallas
kernel run in interpret mode, at the repo's bound of 1e-6 relative
(tests/test_kernels.py): both sides sum f32 products, in different orders.

The ``cuda`` tests skip without a card.  This module imports the JAX package
only inside the tests that compare with it, so on a machine with a card and
no jax the card tests run alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from ddm_tpu_torch.kernels import ddmatvec
from ddm_tpu_torch.solvers.direct import dd_split

torch.set_num_threads(2)

# (n_sub, P, q): the two shapes of tests/test_kernels.py and a ragged P
SHAPES = [(4, 256, 200), (2, 640, 640), (3, 177, 177)]


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


def test_dispatch_cpu_takes_reference_and_cuda_wrapper_rejects_cpu():
    A, d = _inputs(2, 64, 50, seed=3)
    hi, lo = dd_split(torch.as_tensor(A))
    dt = torch.as_tensor(d)
    before = ddmatvec.dd_matvec_cuda.launches
    y = ddmatvec.dd_matvec(hi, lo, dt)
    assert ddmatvec.dd_matvec_cuda.launches == before
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
@pytest.mark.parametrize("n_sub,P,q", SHAPES)
def test_cuda_kernel_matches_reference(cuda_device, n_sub, P, q):
    """The kernel accumulates in f64: against the plain version (f32
    partial sums) to 1e-6, against the f64 truth to 1e-12."""
    A, d = _inputs(n_sub, P, q, seed=P)
    hi, lo = dd_split(torch.as_tensor(A, device=cuda_device))
    dt = torch.as_tensor(d, device=cuda_device)
    before = ddmatvec.dd_matvec_cuda.launches
    y = ddmatvec.dd_matvec(hi, lo, dt)
    torch.cuda.synchronize()
    assert ddmatvec.dd_matvec_cuda.launches == before + 1
    ref = ddmatvec.dd_matvec_reference(hi, lo, dt)
    truth = ((hi.double() + lo.double())[:, :q, :q] @ dt[..., None])[..., 0]
    assert _relerr(y.cpu(), ref.cpu()) < 1e-6
    assert _relerr(y.cpu(), truth.cpu()) < 1e-12


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
    with pytest.raises(NotImplementedError):
        ddmatvec.dd_matvec(hi, lo, dt[..., None])  # multi-RHS


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
        ddmatvec.dd_matvec_cuda.launches = 0
        res = api.solve(p, M)
        return res, api.solution(p, res).cpu(), ddmatvec.dd_matvec_cuda.launches, M

    r_gpu, u_gpu, launches, M = run(cuda_device, "dd")
    r_cpu, u_cpu, _, _ = run("cpu", "f64")
    assert r_gpu.converged and abs(r_gpu.iterations - r_cpu.iterations) <= 2
    assert _relerr(u_gpu, u_cpu) < 1e-6
    assert launches == 3 * M.precs[0].applies > 0
