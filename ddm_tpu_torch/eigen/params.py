"""Eigensolver parameters (reference: dune/ddm/eigensolvers/eigensolver_params.hh:8-62).

Defaults mirror the reference; ``threshold > 0`` switches to adaptive
selection (keep eigenpairs with lambda < threshold, up to nev_max), else
exactly ``nev`` pairs are kept.  The reference's known bug at
eigensolver_params.hh:23 (assigning ncv where nev_max was intended) is NOT
replicated (SURVEY.md snapshot caveats).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..config import ParamTree


@dataclass(frozen=True)
class EigensolverParams:
    """Field inventory mirrors eigensolver_params.hh:8-62.  Which fields are
    live depends on the selected solver ``type`` (eigen/__init__.solve_gevp):

    * dense path ("spectra"/"dense"): nev, nev_max, threshold, precision.
      The dense transform returns the full spectrum deterministically, so
      the iterative-solver controls (ncv, maxit, seed, blocksize, tolerance,
      shift) are accepted for config compatibility but have no effect.
    * iterative path ("krylovschur"/"lobpcg"): additionally maxit, seed,
      blocksize, tolerance (convergence test) and the adaptive nev-doubling
      against threshold; ncv and shift remain compatibility-only (LOBPCG
      has no Krylov basis to size and needs no shift-invert).
    """

    type: str = "spectra"
    nev: int = 16
    ncv: int = 32  # Krylov basis size — compatibility only (see docstring)
    nev_max: int = 16
    maxit: int = 1000
    seed: int = 1
    blocksize: int = 8
    tolerance: float = 1e-5
    # Spectral C-shift: the dense path solves (A + shift*C) v = (lam+shift) C v
    # — the TPU analogue of the reference's shift-invert sigma
    # (spectra.hh:130-138).  EXACT transform (same eigenvectors, lam
    # recovered as 1/mu - shift); its job here is compressing the inverted
    # spectrum's dynamic range to <= 1/shift so the f32 eigh resolves the
    # whole kept block even when a near-kernel mode (mu ~ 1e10) shares the
    # pencil with mid-spectrum essentials — without it, ring pencils'
    # mu ~ 1-20 essentials drown in f32 eigh's eps32*mu_max absolute noise
    # (measured: 86-degree kept-span errors and a 400-iteration GMRES stall
    # at islands 384^2/256, scratch/ring_pencil_compare_r3.py).  NOTE: an
    # identity shift (A + eps*I) is NOT a substitute — it perturbs ring
    # eigenvalues by eps * v^Tv/v^TCv = O(1) (the removed r2 "shift floor").
    shift: float = 1e-3
    threshold: float = -0.5
    # "f64", "f32", or "auto": f32 on TPU (the f64-emulated eigh is ~100x
    # slower there), f64 on CPU.  Coarse-space quality only needs the
    # eigenvectors to *span* a good subspace; f32 is ample for that.
    precision: str = "auto"
    # mixed-precision refinement budget (dense path, downcast only): rounds
    # of f64 subspace iteration and extra seed vectors beyond max_kept.
    # Sized from real bench-scale pencils (scratch/ring_gevp_offline_r3.py):
    # GenEO overlap pencils are accurate at (2, 8); thin-support ring
    # pencils need (4, 24) for exact kept spans — ring callers override.
    refine_iters: int = 2
    refine_buf: int = 8
    # f32 seed for the mixed-precision dense path: "eigh" = full f32
    # eigendecomposition of S; "subspace" = randomized block subspace
    # iteration (seed_iters rounds at width max_kept + refine_buf +
    # seed_oversample) + small Rayleigh-Ritz — measured 0.07 s vs the
    # eigh's 2.5-6.5 s at bench pencil sizes (scratch/gevp_probe2_r3.py).
    # "auto" = subspace (the f64 refinement that follows corrects the
    # slightly less converged span; validated by the wide-spectrum fixture
    # tests/test_geneo.py and end-to-end bench iteration counts).
    seed_mode: str = "auto"
    seed_iters: int = 8
    seed_oversample: int = 16
    # Whitener for the dense SPD path: "staged" = mixed-precision staged
    # congruence whitening (f32 Cholesky stages + f64 square matmuls,
    # solvers/direct.py:staged_whiten_batched — replaces the scalar-emulated
    # f64 Cholesky + triangular inverse, measured 4.8 s -> ~1.3 s at ring
    # bench scale); "chol" = the classic in-jit f64 Cholesky; "auto" =
    # staged exactly where the mixed-precision downcast path runs (TPU/f32
    # on f64 pencils), chol otherwise.  Config-revertible via
    # eigensolver.whiten.
    whiten: str = "auto"

    @staticmethod
    def from_ptree(sub: ParamTree) -> "EigensolverParams":
        d = EigensolverParams()
        nev = sub.get("nev", d.nev)
        threshold = sub.get("threshold", d.threshold)
        nev_max = sub.get("nev_max", max(nev, 16))
        if threshold > 0:
            nev_max = max(nev_max, nev)
        return EigensolverParams(
            type=sub.get("type", d.type),
            nev=nev,
            ncv=sub.get("ncv", 2 * nev),
            nev_max=nev_max,
            maxit=sub.get("maxit", d.maxit),
            seed=sub.get("seed", d.seed),
            blocksize=sub.get("blocksize", d.blocksize),
            tolerance=sub.get("tolerance", d.tolerance),
            shift=sub.get("shift", d.shift),
            threshold=threshold,
            precision=sub.get("precision", d.precision),
            refine_iters=sub.get("refine_iters", d.refine_iters),
            refine_buf=sub.get("refine_buf", d.refine_buf),
            seed_mode=sub.get("seed_mode", d.seed_mode),
            seed_iters=sub.get("seed_iters", d.seed_iters),
            seed_oversample=sub.get("seed_oversample", d.seed_oversample),
            whiten=sub.get("whiten", d.whiten),
        )

    def with_refine(self, iters: int, buf: int) -> "EigensolverParams":
        """Copy with a different mixed-precision refinement budget (used by
        ring coarse spaces, whose pencils need the larger budget)."""
        from dataclasses import replace

        return replace(self, refine_iters=iters, refine_buf=buf)

    @property
    def max_kept(self) -> int:
        """Static width of the basis batch."""
        return self.nev_max if self.threshold > 0 else self.nev
