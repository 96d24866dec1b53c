"""Dual (Woodbury) exact solver for the link-matrix draw.

The reference solves ``(X'X + lambda I) B = RHS`` with blocked CG
(src/macau.jl [MED], SURVEY §4.4).  When an entity has FEWER instances
than features (N < F — the tall-feature ECFP regime the CG path exists
for), the Woodbury identity

    (X'X + lam I)^{-1} = (I - X'(XX' + lam I)^{-1} X) / lam

moves the solve to the N x N dual Gramian ``G = XX'``.  G is CONSTANT
across sweeps (only ``lambda_beta`` changes), so one eigendecomposition
``G = Q diag(d) Q'`` — computed once at engine build — turns every
sweep's beta draw into four matmuls and a diagonal scale:

    t  = X rhs                         [N, K]
    s  = Q' t  /  (d + lam)            [N, K]
    B  = (rhs - X' (Q s)) / lam        [F, K]

This is an EXACT direct solve (to floating-point roundoff), strictly
tighter than CG's f32 tolerance floor (~1e-5), and it matches the NumPy
oracle's dense ``np.linalg.solve`` at oracle-equivalence tolerance.  Per
sweep it costs a few dense [N, N] x [N, K] matmuls instead of ~21
preconditioned-CG iterations at the ChEMBL bench shape (15k x 32k ECFP).

The one-time ``eigh`` runs on the HOST (scipy ``syevd``, ~160 s at N=15k
once per engine, cached by ``dual_cache_dir``).  In f32 the eigh-based solve
carries a backward error ~eps*kappa; iterative refinement (config
``dual_refine``, default 1) runs in the N-space dual system against the
exact stored G (:func:`dual_solve_g`) and brings the measured true relative
residual from 1.6e-4 to 1.6e-6 on the 15k x 32k ECFP system — below the CG
f32 floor (~1e-5).  All contractions run at Precision.HIGHEST: the final
``rhs - X' z`` cancellation amplifies matmul rounding by ~|X'X|/lam, so bf16
operands (or a reduced-precision default dot such as TF32) would leave ~1e-1
true residual.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import numpy as np


def build_dual_gram(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                    shape: Tuple[int, int]) -> np.ndarray:
    """Host-side G = X X' (f64) from COO features."""
    import scipy.sparse as sp
    X = sp.coo_matrix((np.asarray(vals, np.float64), (rows, cols)),
                      shape=shape).tocsr()
    return np.asarray((X @ X.T).todense())


def dual_eig(G: np.ndarray, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """One-time host eigendecomposition of the dual Gramian.

    Returns (Q [N, N], d [N]) in ``dtype``; d clipped to >= 0 (G is PSD;
    roundoff can produce tiny negatives).  f64 compute for small N or
    f64 engines; f32 ``syevd`` above that (163 s at N=15k on a 4-core
    host — the f64 factorization would be ~4x that for no statistical
    gain once refinement runs).
    """
    import scipy.linalg as sla
    f64 = np.dtype(dtype) == np.float64 or G.shape[0] <= 2048
    w, Q = sla.eigh(np.asarray(G, np.float64 if f64 else np.float32),
                    driver="evd")
    return Q.astype(dtype), np.maximum(w, 0.0).astype(dtype)


def dual_eig_cached(rows, cols, vals, shape, dtype,
                    cache_dir) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(Q, d, G) with the expensive eigh cached on disk.

    The eigendecomposition is a pure function of the feature matrix
    (~270 s at N=15k), so when ``config.dual_cache_dir`` is set the
    (Q, d) pair is stored under a content hash of the COO features —
    repeat engine builds on the same side information (the normal
    reference workflow: many runs over one ECFP file) skip the eigh.
    G is always rebuilt (a cheap sparse product).
    """
    G = build_dual_gram(rows, cols, vals, shape)
    if not cache_dir:
        Q, d = dual_eig(G, dtype)
        return Q, d, G
    import hashlib
    import os
    h = hashlib.sha1()
    for a in (np.asarray(rows), np.asarray(cols),
              np.asarray(vals, np.float64),
              np.asarray(shape, np.int64),
              np.frombuffer(np.dtype(dtype).str.encode(), np.uint8)):
        h.update(np.ascontiguousarray(a).tobytes())
    path = os.path.join(cache_dir, f"dualeig_{h.hexdigest()[:16]}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return z["Q"], z["d"], G
    Q, d = dual_eig(G, dtype)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, Q=Q, d=d)
    os.replace(tmp, path)
    return Q, d, G


def dual_solve(Q: jax.Array, d: jax.Array, lam, rhs: jax.Array,
               spmm_fwd: Callable[[jax.Array], jax.Array],
               spmm_t: Callable[[jax.Array], jax.Array]) -> jax.Array:
    """(X'X + lam I)^{-1} rhs via the cached dual eigendecomposition.

    All contractions run at Precision.HIGHEST: the final
    ``rhs - X' t2`` cancels almost completely along the data directions,
    so matmul rounding is amplified by ~|X'X|/lam — a reduced-precision
    default dot (or bf16 operands in the spmm) turns an exact solve into
    ~1e-1 true relative residual (r2 session-4 measurement).
    """
    hi = jax.lax.Precision.HIGHEST
    t = spmm_fwd(rhs)                        # [N, K]
    s = jax.numpy.matmul(Q.T, t, precision=hi)
    s = s / (d + lam)[:, None]
    t2 = jax.numpy.matmul(Q, s, precision=hi)
    return (rhs - spmm_t(t2)) / lam


def dual_solve_g(Q: jax.Array, d: jax.Array, G: jax.Array, lam,
                 rhs: jax.Array,
                 spmm_fwd: Callable[[jax.Array], jax.Array],
                 spmm_t: Callable[[jax.Array], jax.Array],
                 n_refine: int) -> Tuple[jax.Array, jax.Array]:
    """(beta, uhat) with ALL iteration in the N-space dual system.

    Solve ``(G + lam) z = X rhs`` via the cached eigenbasis, refine the
    z-residual against the EXACT stored G (the eigh carries f32 backward
    error ~eps*kappa; one refinement contracts it quadratically), then

        beta = (rhs - X' z) / lam
        uhat = X beta = z            (push-through identity:
                                      X (X'X+lam)^{-1} = (XX'+lam)^{-1} X)

    vs iterating in F-space this does 3 X passes per sweep instead of 8
    (rhs build included) and gets uhat without any X pass at all.
    Contractions run at Precision.HIGHEST (see dual_solve note).
    """
    hi = jax.lax.Precision.HIGHEST
    mm = functools.partial(jax.numpy.matmul, precision=hi)

    def apply_inv(t):
        s = mm(Q.T, t) / (d + lam)[:, None]
        return mm(Q, s)

    t0 = spmm_fwd(rhs)                       # [N, K]
    z = apply_inv(t0)
    for _ in range(n_refine):
        r = t0 - mm(G, z) - lam * z
        z = z + apply_inv(r)
    beta = (rhs - spmm_t(z)) / lam
    return beta, z


def use_dual(beta_solver, n: int, num_features: int,
             itemsize: int, budget_gb: float) -> bool:
    """Solver auto-selection (config.beta_solver):

    - "dual" forces it; "cg" forbids it.
    - auto (None): N < F (the dual system is the smaller one), F large
      enough that CG would be the alternative (>= 4096 — below that the
      FF path usually applies anyway), and Q + G fit the budget.
    """
    if beta_solver == "dual":
        return True
    if beta_solver is not None:
        return False
    return (n < num_features and num_features >= 4096
            and 2 * n * n * itemsize <= budget_gb * 1e9)
