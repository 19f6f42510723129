"""The port's benchmark entry point (ddm_tpu_torch/bench.py) on the other
configurations of its environment, each against the JAX package's bench.py
on the CPU: 3-D islands 6^3 / 8 subdomains, steel-rubber elasticity 16^2 /
4, and dd precision at islands 16^2 / 4, all at overlap 2 and nev 2.
``main(device="cpu")`` must print the variant's metric name and take the
JAX bench's device and sequential-baseline iterations."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ddm_tpu_torch import bench as tbench  # noqa: E402

from blas_threads import one_blas_thread  # noqa: E402,F401

torch.set_num_threads(2)


PARTS, OVERLAP, NEV = 2, 2, 2
TRUE_RES_MAX = 1e-7  # bench.py's baselines, tests/test_bench_baselines.py
# a hung baseline worker fails its test well inside the tier-1 time limit
WORKER_TIMEOUT_S = 120.0
# variant: (environment, gridsize, dim, metric)
VARIANTS = {
    "3d": ({"DDM_BENCH_DIM": "3"}, 6, 3,
           "poisson_islands_geneo_ras_6x6x6_8sub_setup_solve"),
    "elasticity": ({"DDM_BENCH_PROBLEM": "elasticity"}, 16, 2,
                   "elasticity_steel_rubber_geneo_ras_16x16_4sub_setup_solve"),
    "dd": ({"DDM_BENCH_PRECISION": "dd"}, 16, 2,
           "poisson_islands_geneo_ras_16x16_4sub_setup_solve"),
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_jax(variant, monkeypatch, capsys):
    import bench as jbench

    env, grid, dim, metric = VARIANTS[variant]
    for k in list(os.environ):
        if k.startswith("DDM_BENCH_"):
            monkeypatch.delenv(k)
    if dim == 3:
        # bench.py sets its setup slab for 3-D in the process environment
        monkeypatch.setenv("DDM_TPU_BATCH_CHUNK", "24")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pj = jbench.build_problem(grid, PARTS, OVERLAP, NEV, dim=dim)
    jdev = jbench.run_tpu(pj, NEV, attempts=1)
    jseq = jbench.run_cpu_baseline(pj, NEV)
    del pj

    monkeypatch.setattr(tbench, "WORKER_TIMEOUT_S", WORKER_TIMEOUT_S)
    monkeypatch.setenv("DDM_BENCH_GRIDSIZE", str(grid))
    monkeypatch.setenv("DDM_BENCH_PARTS", str(PARTS))
    monkeypatch.setenv("DDM_BENCH_NEV", str(NEV))
    monkeypatch.setenv("DDM_BENCH_ATTEMPTS", "1")
    capsys.readouterr()
    line = tbench.main([], device="cpu")
    assert len(capsys.readouterr().out.splitlines()) == 1
    assert line["metric"] == metric
    assert jdev["converged"]
    assert line["iters"] == jdev["iters"]
    seq = line["cpu_sequential_baseline"]
    par = line["cpu_parallel_baseline"]
    assert seq["converged"] and par["converged"] and jseq["converged"]
    assert seq["iters"] == jseq["iters"]
    assert abs(par["iters"] - seq["iters"]) <= 1
    residuals = [line["true_rel_res"], jdev["true_rel_res"],
                 seq["true_rel_res"], par["true_rel_res"]]
    # elasticity's headline is full geneo already: no like-for-like run
    assert ("iters_geneo" in line) == (variant != "elasticity")
    if "iters_geneo" in line:
        residuals.append(line["true_rel_res_geneo"])
    assert max(residuals) <= TRUE_RES_MAX
