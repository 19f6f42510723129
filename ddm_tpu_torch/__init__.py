"""ddm_tpu_torch — the PyTorch/CUDA port of ``ddm_tpu``.

Two-level overlapping Schwarz (restricted additive Schwarz + a GenEO or
ring-GenEO coarse space + Galerkin coarse correction) under
left-preconditioned restarted GMRES, written for one NVIDIA H100.  ``ddm_tpu`` (JAX) stays the reference;
the tests in ``tests/test_torch_*.py`` hold this package against it.

Conventions:

* every function that creates tensors takes an explicit ``device=``; the
  entry point ``api.setup_problem`` defaults to the CUDA card and raises
  without CUDA — the CPU runs only when asked for;
* every floating-point tensor is explicitly float64 unless a double-single
  (float32 hi/lo) pair is meant;
* batches are written out as a leading subdomain dimension, loops are
  Python loops (no jit/vmap/pytrees);
* the framework-neutral numpy modules ``config.py``, ``core/indexmaps.py``,
  ``fem/grids.py``, ``fem/msh.py`` and ``eigen/params.py`` are copies of
  their ``ddm_tpu`` counterparts, so both packages build the same
  subdomains;
* a hand-written CUDA kernel runs only on CUDA tensors; CPU tensors take
  its plain PyTorch version.  There is no fallback from one to the other;
* one problem can also run on several devices: ``api.build_preconditioner``
  and ``api.solve`` take a ``core.mesh.SubdomainMesh`` and shard the
  subdomain batch over the ranks of a ``torch.distributed`` group.

This package never imports ``jax``.
"""

__version__ = "0.1.0"
