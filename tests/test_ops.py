"""Unit tests for the numerical kernels: Cholesky-MVN, Bartlett Wishart,
Normal-Wishart conditional, block CG, precision assembly."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.stats

from bayesiandatafusion_jl_tpu.ops.cg import block_cg
from bayesiandatafusion_jl_tpu.ops.hyper import (bartlett_wishart,
                                                 normal_wishart_update)
from bayesiandatafusion_jl_tpu.ops.mvn import chol_sample, chol_solve


def _spd(rng, k, batch=()):
    a = rng.standard_normal(batch + (k, k))
    return a @ np.swapaxes(a, -1, -2) + k * np.eye(k)


def test_chol_solve_matches_numpy():
    rng = np.random.default_rng(0)
    P = _spd(rng, 5, (7,))
    b = rng.standard_normal((7, 5))
    x = np.asarray(chol_solve(jnp.asarray(P), jnp.asarray(b)))
    want = np.stack([np.linalg.solve(P[i], b[i]) for i in range(7)])
    np.testing.assert_allclose(x, want, rtol=1e-10)


def test_chol_sample_mean_and_cov():
    # u = mu* + L^{-T} xi must have mean P^{-1} b and covariance P^{-1}
    rng = np.random.default_rng(1)
    K = 3
    P = _spd(rng, K)
    b = rng.standard_normal(K)
    n = 200_000
    xi = jnp.asarray(rng.standard_normal((n, K)))
    Pb = jnp.broadcast_to(jnp.asarray(P), (n, K, K))
    bb = jnp.broadcast_to(jnp.asarray(b), (n, K))
    u = np.asarray(chol_sample(Pb, bb, xi))
    mean_want = np.linalg.solve(P, b)
    cov_want = np.linalg.inv(P)
    np.testing.assert_allclose(u.mean(0), mean_want, atol=4e-2)
    np.testing.assert_allclose(np.cov(u.T), cov_want, atol=4e-2)


def test_bartlett_wishart_mean():
    # E[Wishart(V, nu)] = nu * V
    rng = np.random.default_rng(2)
    K, nu, n = 3, 10.0, 20_000
    V = _spd(rng, K)
    Vinv = np.linalg.inv(V)
    M = np.linalg.cholesky(Vinv)
    acc = np.zeros((K, K))
    chi2 = 2.0 * rng.gamma(np.broadcast_to((nu - np.arange(K)) / 2.0,
                                           (n, K)))
    normals = rng.standard_normal((n, K, K))
    lam, _ = jax.vmap(lambda c, z: bartlett_wishart(c, z, jnp.asarray(M)))(
        jnp.asarray(chi2), jnp.asarray(normals))
    mean = np.asarray(lam).mean(0)
    np.testing.assert_allclose(mean, nu * V, rtol=6e-2)


def test_normal_wishart_posterior_concentration():
    # with many residual rows of known covariance C, E[Lambda] -> C^{-1}
    rng = np.random.default_rng(3)
    K, N = 3, 50_000
    C = _spd(rng, K) / 10
    S = rng.standard_normal((N, K)) @ np.linalg.cholesky(C).T
    nu0 = float(K)
    draws = []
    for t in range(30):
        chi2 = 2.0 * rng.gamma((nu0 + N - np.arange(K)) / 2.0)
        mu, lam = normal_wishart_update(
            jnp.asarray(S), 2.0, nu0, jnp.asarray(chi2),
            jnp.asarray(rng.standard_normal((K, K))),
            jnp.asarray(rng.standard_normal(K)))
        draws.append(np.asarray(lam))
    np.testing.assert_allclose(np.mean(draws, 0), np.linalg.inv(C),
                               rtol=0.15)


def test_block_cg_matches_direct():
    rng = np.random.default_rng(4)
    F, K = 40, 5
    X = (rng.random((60, F)) < 0.3).astype(np.float64)
    lam = 0.7
    A = X.T @ X + lam * np.eye(F)
    rhs = rng.standard_normal((F, K))
    want = np.linalg.solve(A, rhs)
    Xj = jnp.asarray(X)

    def matvec(v):
        return Xj.T @ (Xj @ v) + lam * v

    x, iters, resid = block_cg(matvec, jnp.asarray(rhs),
                               jnp.zeros((F, K)), tol=1e-12, maxiter=500)
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-8, atol=1e-8)
    assert int(iters) < 500
    # reported residual is the recomputed TRUE residual (both converged
    # far below tol; exact float values differ between BLAS paths)
    true_rel = np.linalg.norm(rhs - A @ np.asarray(x), axis=0) \
        / np.linalg.norm(rhs, axis=0)
    assert float(resid) < 1e-10 and true_rel.max() < 1e-10, \
        (float(resid), true_rel.max())


def test_block_cg_warm_start_fewer_iters():
    rng = np.random.default_rng(5)
    F, K = 60, 4
    X = (rng.random((80, F)) < 0.3).astype(np.float64)
    A = X.T @ X + 0.5 * np.eye(F)
    rhs = rng.standard_normal((F, K))
    want = np.linalg.solve(A, rhs)
    Xj = jnp.asarray(X)

    def matvec(v):
        return Xj.T @ (Xj @ v) + 0.5 * v

    _, it_cold, _ = block_cg(matvec, jnp.asarray(rhs), jnp.zeros((F, K)),
                             tol=1e-10, maxiter=500)
    _, it_warm, _ = block_cg(matvec, jnp.asarray(rhs),
                             jnp.asarray(want + 1e-6), tol=1e-10,
                             maxiter=500)
    assert int(it_warm) < int(it_cold)


def test_block_cg_f32_illconditioned_hits_floor():
    """ECFP-like ill-conditioned system in f32: Jacobi PCG must still reach
    the floored ~1e-5 relative TRUE residual (the engine's production
    tolerance) within the default iteration budget."""
    rng = np.random.default_rng(7)
    N, F, K = 400, 300, 4
    # wildly varying column counts: power-law style support
    p = 0.02 + 0.6 * (np.arange(F) < 10)
    X = (rng.random((N, F)) < p).astype(np.float32)
    lam = np.float32(0.3)
    Xj = jnp.asarray(X, jnp.float32)

    def matvec(v):
        return Xj.T @ (Xj @ v) + lam * v

    rhs = jnp.asarray(rng.standard_normal((F, K)), jnp.float32)
    diag = jnp.asarray((X ** 2).sum(0) + lam, jnp.float32)
    x, it, resid = block_cg(matvec, rhs, jnp.zeros((F, K), jnp.float32),
                            tol=1e-5, maxiter=200, precond_diag=diag)
    assert float(resid) < 5e-5, (float(resid), int(it))
    assert int(it) < 200


def test_sample_lambda_beta_posterior_moments():
    """lambda_beta | beta, Lambda ~ Gamma((nu+F*K)/2, rate=(nu/mean +
    tr(beta' beta Lambda))/2) — empirical mean/var over many draws must
    match the scipy-computed posterior moments (pins the SURVEY §4.5 [MED]
    parameterization: shape/RATE, trace form tr(beta' beta Lambda))."""
    from bayesiandatafusion_jl_tpu.ops.hyper import sample_lambda_beta
    rng = np.random.default_rng(8)
    F, K = 7, 3
    beta = rng.standard_normal((F, K))
    Lam = _spd(rng, K)
    nu_beta, lb_mean = 2.0, 1.5
    shape = (nu_beta + F * K) / 2.0
    rate = (nu_beta / lb_mean + np.trace(beta.T @ beta @ Lam)) / 2.0
    n = 200_000
    g = jnp.asarray(rng.gamma(shape, 1.0, n))
    draws = np.asarray(jax.vmap(
        lambda gi: sample_lambda_beta(jnp.asarray(beta), jnp.asarray(Lam),
                                      gi, nu_beta, lb_mean))(g))
    want = scipy.stats.gamma(a=shape, scale=1.0 / rate)
    np.testing.assert_allclose(draws.mean(), want.mean(), rtol=2e-2)
    np.testing.assert_allclose(draws.var(), want.var(), rtol=5e-2)


def test_sample_alpha_posterior_moments():
    """alpha_r | residuals ~ Gamma(a0 + n/2, rate=b0 + SSE/2) (SURVEY
    §4.5) — same scipy moment cross-check."""
    from bayesiandatafusion_jl_tpu.ops.hyper import sample_alpha
    rng = np.random.default_rng(9)
    n_obs, sse, a0, b0 = 500, 123.4, 1e-3, 1e-3
    shape = a0 + n_obs / 2.0
    rate = b0 + sse / 2.0
    n = 200_000
    g = jnp.asarray(rng.gamma(shape, 1.0, n))
    draws = np.asarray(jax.vmap(
        lambda gi: sample_alpha(jnp.asarray(sse), n_obs, gi, a0, b0))(g))
    want = scipy.stats.gamma(a=shape, scale=1.0 / rate)
    np.testing.assert_allclose(draws.mean(), want.mean(), rtol=2e-2)
    np.testing.assert_allclose(draws.var(), want.var(), rtol=5e-2)


def test_bucketed_matvec_matches_dense():
    from bayesiandatafusion_jl_tpu.ops.spmv import (build_bucketed_matvec,
                                                    bucketed_spmm)
    rng = np.random.default_rng(6)
    N, F, K = 37, 53, 4
    dense = (rng.random((N, F)) < 0.15).astype(np.float64)
    r, c = np.nonzero(dense)
    mv = build_bucketed_matvec(r.astype(np.int32), c.astype(np.int32),
                               (N, F), widths=(4, 16), dtype=np.float64)
    V = rng.standard_normal((F, K))
    U = rng.standard_normal((N, K))
    np.testing.assert_allclose(
        np.asarray(bucketed_spmm(mv["fwd"], N, jnp.asarray(V))),
        dense @ V, rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(bucketed_spmm(mv["t"], F, jnp.asarray(U))),
        dense.T @ U, rtol=1e-10)


def test_nystrom_precond_same_solution():
    """Nystrom-preconditioned CG (ops/precond.py) must converge to the
    SAME solution as Jacobi CG (preconditioning changes iterates, never
    the solve, so the Gibbs draw is unchanged) within a comparable
    iteration budget."""
    import jax.numpy as jnp
    from bayesiandatafusion_jl_tpu.ops.cg import block_cg
    from bayesiandatafusion_jl_tpu.ops.precond import (build_nystrom,
                                                       nystrom_apply)
    rng = np.random.default_rng(0)
    n, f, k = 1500, 1024, 4
    # skewed column popularity (power law) like ECFP fingerprints
    col_p = 1.0 / np.arange(1, f + 1) ** 0.9
    col_p /= col_p.sum()
    rows = np.repeat(np.arange(n), 30)
    cols = rng.choice(f, size=len(rows), p=col_p)
    key = np.unique(rows.astype(np.int64) * f + cols)
    rows, cols = (key // f).astype(np.int32), (key % f).astype(np.int32)
    vals = np.ones(len(rows))
    import scipy.sparse as sp
    X = sp.coo_matrix((vals, (rows, cols)), shape=(n, f)).tocsr()
    lam = 2.0
    rhs = jnp.asarray(rng.standard_normal((f, k)))
    Xj = jnp.asarray(X.todense())

    def matvec(V):
        return Xj.T @ (Xj @ V) + lam * V

    colcount = jnp.asarray(np.asarray(X.power(2).sum(axis=0)).ravel())
    x_j, it_j, res_j = block_cg(matvec, rhs, jnp.zeros_like(rhs),
                                tol=1e-10, maxiter=500,
                                precond_diag=colcount + lam)
    U, d = build_nystrom(rows, cols, vals, (n, f), rank=128, seed=1)
    Uj, dj = jnp.asarray(U), jnp.asarray(d)
    x_n, it_n, res_n = block_cg(matvec, rhs, jnp.zeros_like(rhs),
                                tol=1e-10, maxiter=500,
                                precond=lambda r: nystrom_apply(Uj, dj,
                                                                lam, r))
    np.testing.assert_allclose(np.asarray(x_n), np.asarray(x_j),
                               rtol=1e-6, atol=1e-6)
    assert float(res_n) < 1e-8 and float(res_j) < 1e-8
    # measured on this skewed system: comparable counts (85 vs 75); the
    # knob is opt-in for spectra with a heavy correlated head
    assert int(it_n) < int(it_j) * 1.5, (int(it_n), int(it_j))


def test_bucket_gramian_chunked_bitwise():
    """Row-chunked bucket_gramian (the arbitrary-scale gather path) must
    equal the one-shot einsum exactly: every row's W-reduction stays
    inside one chunk, so no reduction order changes."""
    from bayesiandatafusion_jl_tpu.ops.gramian import bucket_gramian
    rng = np.random.default_rng(3)
    rows, W, K, Np = 37, 8, 4, 50
    U = jnp.asarray(rng.standard_normal((Np, K)))
    V = jnp.asarray(rng.standard_normal((Np + 9, K)))
    val = jnp.asarray(rng.standard_normal((rows, W)))
    mask = jnp.asarray((rng.random((rows, W)) < 0.8).astype(np.float64))
    # arity 2 and arity 3 (Hadamard partner product)
    for partners, parts in [
        ([U], [jnp.asarray(rng.integers(0, Np, (rows, W)).astype(np.int32))]),
        ([U, V], [jnp.asarray(rng.integers(0, Np, (rows, W)).astype(np.int32)),
                  jnp.asarray(rng.integers(0, Np + 9, (rows, W)).astype(np.int32))]),
    ]:
        P1, b1 = bucket_gramian(partners, parts, val, mask)
        # budget of 1000 bytes forces many chunks incl. a ragged tail
        P2, b2 = bucket_gramian(partners, parts, val, mask,
                                max_gather_bytes=1000.0)
        np.testing.assert_array_equal(np.asarray(P1), np.asarray(P2))
        np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))


@pytest.mark.parametrize("fuse_lambda", [False, True])
def test_assemble_precision_matches_direct(fuse_lambda):
    """One segment-sum over all buckets' rows equals a direct per-row
    NumPy accumulation (alpha-scaled), with Lambda in P or left to the
    sampler (fuse_lambda, the head-split contract)."""
    from bayesiandatafusion_jl_tpu.ops.gramian import assemble_precision
    rng = np.random.default_rng(13)
    rows, W, K, Np, n = 53, 8, 4, 40, 29
    U = jnp.asarray(rng.standard_normal((Np, K)))
    part = jnp.asarray(rng.integers(0, Np, (rows, W)).astype(np.int32))
    val = jnp.asarray(rng.standard_normal((rows, W)))
    mask = jnp.asarray((rng.random((rows, W)) < 0.8).astype(np.float64))
    inst = jnp.asarray(rng.integers(0, n, rows).astype(np.int32))
    contribs = [(1.7, [U], {"part": [part], "val": val, "mask": mask,
                            "inst": inst})]
    Lam = _spd(rng, K)
    prior = rng.standard_normal((n, K))
    P, b = assemble_precision(jnp.asarray(Lam), jnp.asarray(prior),
                              contribs, n, fuse_lambda=fuse_lambda)
    z = np.asarray(U)[np.asarray(part)] * np.asarray(mask)[..., None]
    P_rows = np.einsum("rwk,rwl->rkl", z, z)
    b_rows = np.einsum("rwk,rw->rk", z, np.asarray(val))
    P_ref = np.zeros((n, K, K)) if fuse_lambda else np.tile(Lam, (n, 1, 1))
    b_ref = prior @ Lam
    for r in range(rows):
        P_ref[int(inst[r])] += 1.7 * P_rows[r]
        b_ref[int(inst[r])] += 1.7 * b_rows[r]
    np.testing.assert_allclose(np.asarray(P), P_ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(b), b_ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("jitter", [0.0, 1e-3])
@pytest.mark.parametrize("K", [1, 4, 8, 32, 48, 96, 128])
def test_chol_sample_matches_numpy_f64(K, jitter):
    """chol_sample against a NumPy/SciPy f64 restatement of the per-row
    draw u = P^{-1} b + L^{-T} xi (P + jitter I = L L^T), at every latent
    width the engines run (the K range the removed fused samplers
    covered, and beyond)."""
    rng = np.random.default_rng(K)
    B = 5
    P = _spd(rng, K, (B,))
    b = rng.standard_normal((B, K))
    xi = rng.standard_normal((B, K))
    got = np.asarray(chol_sample(jnp.asarray(P), jnp.asarray(b),
                                 jnp.asarray(xi), jitter))
    want = np.empty((B, K))
    for i in range(B):
        L = np.linalg.cholesky(P[i] + jitter * np.eye(K))
        want[i] = (sla.cho_solve((L, True), b[i])
                   + sla.solve_triangular(L, xi[i], lower=True, trans="T"))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_chol_sample_dispatch_adds_lambda():
    """chol_sample_dispatch(Lambda=...) samples from P + Lambda (the
    head-split accumulators leave Lambda out of P), with the configured
    jitter; without Lambda it is chol_sample itself."""
    from bayesiandatafusion_jl_tpu.ops.mvn import chol_sample_dispatch
    from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
    rng = np.random.default_rng(17)
    B, K = 6, 5
    P = jnp.asarray(_spd(rng, K, (B,)))
    Lam = jnp.asarray(_spd(rng, K))
    b = jnp.asarray(rng.standard_normal((B, K)))
    xi = jnp.asarray(rng.standard_normal((B, K)))
    cfg = MacauConfig(num_latent=K, chol_jitter=1e-3)
    np.testing.assert_allclose(
        np.asarray(chol_sample_dispatch(cfg, P, b, xi, Lambda=Lam)),
        np.asarray(chol_sample(P + Lam, b, xi, 1e-3)), rtol=1e-12,
        atol=1e-12)
    np.testing.assert_array_equal(
        np.asarray(chol_sample_dispatch(cfg, P, b, xi)),
        np.asarray(chol_sample(P, b, xi, 1e-3)))


def test_int8_pair_ok_layout_invariant_guards():
    """Eligibility comes from the observation index, not a stored layout:
    counts beyond int8 and int32-overflowable big-axis fibers decline."""
    from bayesiandatafusion_jl_tpu.ops.dense_gram import int8_pair_ok
    rng = np.random.default_rng(3)
    idx = np.stack([rng.integers(0, 10, 500), rng.integers(0, 8, 500),
                    rng.integers(0, 5, 500)], 1)
    assert int8_pair_ok(idx, (10, 8, 5))
    # duplicate multiplicity > 127
    dup = np.tile(np.array([[1, 2, 3]]), (130, 1))
    assert not int8_pair_ok(np.concatenate([idx, dup]), (10, 8, 5))
    # a fiber along the big partner axis (axis 1) that would overflow the
    # int32 accumulator: 140k observations at fixed (axis0, axis2)
    n_fib = 140_000
    fib = np.stack([np.zeros(n_fib, np.int64),
                    rng.integers(0, 200_000, n_fib),
                    np.zeros(n_fib, np.int64)], 1)
    assert not int8_pair_ok(fib, (10, 200_000, 5))


def test_unknown_accumulation_rejected():
    from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
    with pytest.raises(ValueError):
        MacauConfig(accumulation="window")


def test_no_module_imports_tpu_pallas():
    """No module of the package imports the TPU-only Pallas backend: the
    engine runs through XLA on every platform it supports."""
    pkg = pathlib.Path(__file__).resolve().parents[1] / \
        "bayesiandatafusion_jl_tpu"
    bad = []
    for path in sorted(pkg.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            bad += [f"{path.name}: {n}" for n in names
                    if n.startswith("jax.experimental.pallas.tpu")
                    or n.split(".")[:4] == ["jax", "_src", "pallas",
                                            "mosaic"]]
    assert not bad, bad
