"""The port's benchmark entry point (ddm_tpu_torch/bench.py) against the JAX
package's bench.py on the CPU, islands 16^2 / 4 subdomains, nev 2: the same
device-path iterations, the same baseline matrices and baseline
iterations, the parallel baseline within one iteration of the sequential
one, and main's JSON line."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ddm_tpu_torch import bench as tbench  # noqa: E402

from blas_threads import one_blas_thread  # noqa: E402,F401

torch.set_num_threads(2)


GRID, PARTS, OVERLAP, NEV = 16, 2, 2, 2
TRUE_RES_MAX = 1e-7  # bench.py's baselines, tests/test_bench_baselines.py
# a hung baseline worker fails its test well inside the tier-1 time limit
WORKER_TIMEOUT_S = 120.0
KEYS = ("metric", "value", "unit", "vs_baseline", "host_setup_s",
        "cold_total_s", "cpu_sequential_s", "device_geneo_s",
        "vs_baseline_geneo", "iters_geneo", "cpu_parallel_baseline",
        "device", "cpu_count")


def _clean_env(mp):
    for k in list(os.environ):
        if k.startswith("DDM_BENCH_"):
            mp.delenv(k)


@pytest.fixture(scope="module")
def runs():
    """The JAX bench once (problem, one device attempt, the sequential
    baseline) and the port's problem, built under a clean environment."""
    import bench as jbench

    with pytest.MonkeyPatch.context() as mp:
        _clean_env(mp)
        pj = jbench.build_problem(GRID, PARTS, OVERLAP, NEV)
        jdev = jbench.run_tpu(pj, NEV, attempts=1)
        jseq = jbench.run_cpu_baseline(pj, NEV)
        pt = tbench.build_problem(GRID, PARTS, OVERLAP, NEV, device="cpu")
    return dict(pj=pj, jdev=jdev, jseq=jseq, pt=pt, jbench=jbench)


def test_run_device_matches_jax(runs):
    got = tbench.run_device(runs["pt"], NEV, attempts=1)
    want = runs["jdev"]
    assert got["converged"] and want["converged"]
    assert got["iters"] == want["iters"]
    assert max(got["true_rel_res"], want["true_rel_res"]) <= TRUE_RES_MAX
    assert set(got) == set(want)


def test_baseline_matrices_match_jax(runs):
    """The baselines' (A_neu, C) of the equilibrated system, the same
    subdomain index maps."""
    A_t, C_t = tbench._baseline_gevp_mats(runs["pt"])
    A_j, C_j = runs["jbench"]._baseline_gevp_mats(runs["pj"])
    for got, want in ((A_t, A_j), (C_t, C_j)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(runs["pt"].topo.sub2glob,
                                  runs["pj"].topo.sub2glob)


def test_cpu_baseline_matches_jax(runs):
    got = tbench.run_cpu_baseline(runs["pt"], NEV)
    want = runs["jseq"]
    assert got["converged"] and want["converged"]
    assert got["iters"] == want["iters"]
    assert max(got["true_rel_res"], want["true_rel_res"]) <= TRUE_RES_MAX


def test_host_slabs_give_one_copy(runs, monkeypatch):
    """The baselines' batches move to the host slab by slab (the POU
    scaling in place on each): one subdomain per slab gives the bytes of
    one slab for all."""
    from ddm_tpu_torch.coarse.geneo import neumann_matrices

    p = runs["pt"]
    _, B = neumann_matrices(p)
    pou = torch.as_tensor(p.pou)
    whole = tbench._to_host(B.clone(), pou=pou)
    monkeypatch.setattr(tbench, "HOST_SLAB_BYTES", 8 * p.topo.n_pad ** 2)
    np.testing.assert_array_equal(tbench._to_host(B.clone(), pou=pou), whole)
    np.testing.assert_array_equal(whole, tbench._baseline_gevp_mats(p)[1])


def test_ortho_other_than_f64_refused(monkeypatch):
    """bench.py's double-single orthogonalization has no counterpart in the
    port: DDM_BENCH_ORTHO=dd raises before anything is built."""
    _clean_env(monkeypatch)
    monkeypatch.setenv("DDM_BENCH_ORTHO", "dd")
    with pytest.raises(ValueError, match="DDM_BENCH_ORTHO"):
        tbench.build_problem(GRID, PARTS, OVERLAP, NEV, device="cpu")


def test_parallel_baseline_matches_sequential(runs, monkeypatch):
    monkeypatch.setattr(tbench, "WORKER_TIMEOUT_S", WORKER_TIMEOUT_S)
    seq = tbench.run_cpu_baseline(runs["pt"], NEV)
    par = tbench.run_cpu_baseline_parallel(runs["pt"], NEV, n_workers=2)
    assert par["workers"] == 2
    assert par["converged"] and seq["converged"]
    # identical algebra, another summation grouping: one iteration of slack
    assert abs(par["iters"] - seq["iters"]) <= 1
    assert par["true_rel_res"] <= TRUE_RES_MAX


def test_main_prints_one_json_line(monkeypatch, capsys):
    _clean_env(monkeypatch)
    monkeypatch.setattr(tbench, "WORKER_TIMEOUT_S", WORKER_TIMEOUT_S)
    monkeypatch.setenv("DDM_BENCH_GRIDSIZE", str(GRID))
    monkeypatch.setenv("DDM_BENCH_PARTS", str(PARTS))
    monkeypatch.setenv("DDM_BENCH_NEV", str(NEV))
    out = tbench.main([], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(out))
    assert set(KEYS) <= set(line)
    assert line["metric"] == "poisson_islands_geneo_ras_16x16_4sub_setup_solve"
    assert line["device"] == "cpu" and line["cpu_count"] == os.cpu_count()
    assert line["cpu_parallel_baseline"]["converged"]
    assert line["cpu_sequential_baseline"]["converged"]
    with pytest.raises(SystemExit):
        tbench.main(["-gridsize", "16"], device="cpu")
