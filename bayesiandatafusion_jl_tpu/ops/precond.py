"""Nystrom preconditioner for the beta CG solve (SURVEY §4.4).

The reference runs plain (block) CG on ``X'X + lambda I``; ECFP-style
feature Gramians have a heavy-tailed spectrum, so a randomized Nystrom
approximation of the top eigenspace (Frangella, Tropp & Udell, "Randomized
Nystrom Preconditioning", 2021 — public method) deflates the head and cuts
the iteration count several-fold.  Preconditioning changes CG ITERATES,
never the solution, so the noise-injected Gibbs draw stays exact to solver
tolerance and oracle equivalence is untouched.

Built once per engine (host-side, seconds); ``lambda`` enters only as a
shift at apply time, so the factorization is reused across sweeps even
with ``sample_lambda_beta``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def build_nystrom(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                  shape: Tuple[int, int], rank: int,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Rank-``rank`` Nystrom factorization of A = X'X: returns (U [F, r]
    orthonormal, d [r] eigenvalue estimates, descending)."""
    import scipy.sparse as sp
    X = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
    F = shape[1]
    rng = np.random.default_rng(seed)
    Om = rng.standard_normal((F, rank))
    Y = X.T @ (X @ Om)                            # [F, r] sketch
    # shift for numerical PSD-ness (Frangella et al. alg. 3)
    nu = np.sqrt(F) * np.finfo(np.float64).eps * np.linalg.norm(Y, "fro")
    Ynu = Y + nu * Om
    C = np.linalg.cholesky(Om.T @ Ynu)
    from scipy.linalg import solve_triangular
    B = solve_triangular(C, Ynu.T, lower=True).T  # [F, r]
    U, s, _ = np.linalg.svd(B, full_matrices=False)
    d = np.maximum(s * s - nu, 0.0)
    return U, d


def resolve_nystrom_rank(cfg_rank, num_features: int) -> int:
    """Resolve MacauConfig.cg_nystrom_rank: None = auto (rank 1024 for
    F >= 16384, rank 512 for F >= 8192 — at the ChEMBL bench shape,
    15k x 32k ECFP with int8 slabs, rank 1024 cuts CG 32 -> 21 iterations
    and rank 512 to 24), 0 = off, int = that rank.  Callers additionally
    skip the build when F < 4x the rank."""
    if cfg_rank is not None:
        return int(cfg_rank)
    if num_features >= 16384:
        return 1024
    return 512 if num_features >= 8192 else 0


def nystrom_apply(U, d, lam, r):
    """P^{-1} r for P = U (D + lam I) U' / (d_min + lam) + (I - U U')
    — jax-traceable; ``lam`` may be a traced scalar (per-sweep lambda_beta).
    """
    t = U.T @ r                                   # [rank, K]
    head = U @ (t / (d + lam)[:, None])
    return (d[-1] + lam) * head + (r - U @ t)
