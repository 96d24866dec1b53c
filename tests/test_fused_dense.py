"""The single-array fused dense path (ops/dense_gram.fused_* — the
sparse-regime Gramian, VERDICT r2 next-round #1).

Covers: the layout-invariant encoding eligibility, numerical agreement of
fused_gram_contrib with the direct dense math in both orientations and
output conventions, and the full engine running through the fused plan
(oracle-equivalent at 1e-8 under injected randoms in f64)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.ops import dense_gram as dg
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig


# ---------------------------------------------------------------------------
# encoding eligibility (layout-invariant, host-side)
# ---------------------------------------------------------------------------

def _coo(rng, n0, n1, nnz):
    lin = rng.choice(n0 * n1, size=nnz, replace=False)
    return np.stack([lin // n1, lin % n1], 1).astype(np.int64)


def test_encode_ratings_grid():
    rng = np.random.default_rng(0)
    idx = _coo(rng, 40, 30, 300)
    vals = rng.integers(1, 6, 300).astype(np.float64)   # 1..5 stars
    enc = dg.fused_pair_encode(idx, vals, (40, 30))
    assert enc is not None
    s, m = enc
    e = dg.encode_fused_values(vals, s, m)
    assert e.dtype == np.int8 and (e != 0).all()
    np.testing.assert_allclose(s * (e.astype(np.float64) + m), vals,
                               rtol=0, atol=1e-12)


def test_encode_half_star_grid_and_binary():
    rng = np.random.default_rng(1)
    idx = _coo(rng, 25, 25, 200)
    vals = rng.integers(1, 11, 200) * 0.5               # 0.5..5.0
    s, m = dg.fused_pair_encode(idx, vals, (25, 25))
    e = dg.encode_fused_values(vals, s, m)
    assert (e != 0).all()
    np.testing.assert_allclose(s * (e.astype(np.float64) + m), vals,
                               atol=1e-12)
    # binary labels include 0 -> the shift must keep codes nonzero
    vb = rng.integers(0, 2, 200).astype(np.float64)
    s, m = dg.fused_pair_encode(idx, vb, (25, 25))
    e = dg.encode_fused_values(vb, s, m)
    assert (e != 0).all()
    np.testing.assert_allclose(s * (e.astype(np.float64) + m), vb,
                               atol=1e-12)


def test_encode_declines_continuous_duplicates_and_tensors():
    rng = np.random.default_rng(2)
    idx = _coo(rng, 30, 30, 400)
    cont = rng.standard_normal(400)
    assert dg.fused_pair_encode(idx, cont, (30, 30)) is None
    vals = rng.integers(1, 6, 400).astype(np.float64)
    dup = np.concatenate([idx, idx[:1]], 0)
    dv = np.concatenate([vals, vals[:1]])
    assert dg.fused_pair_encode(dup, dv, (30, 30)) is None
    idx3 = np.concatenate([idx, idx[:, :1]], 1)
    assert dg.fused_pair_encode(idx3, vals, (30, 30, 30)) is None


def test_encode_wide_grid_declines():
    rng = np.random.default_rng(3)
    idx = _coo(rng, 30, 30, 500)
    vals = rng.choice([0.0, 1.0, 1000.0], 500)   # range/step = 1000 > 253
    assert dg.fused_pair_encode(idx, vals, (30, 30)) is None


# ---------------------------------------------------------------------------
# fused_pair_plan: hybrid residual + bounded-error grids (VERDICT r3 #2)
# ---------------------------------------------------------------------------

def test_plan_duplicates_ride_residual():
    """Duplicate (i, j) observations no longer decline the fused path:
    the first occurrence per cell goes into V8, the rest become the
    exact-valued gather residual."""
    rng = np.random.default_rng(5)
    idx = _coo(rng, 30, 30, 200)
    vals = rng.integers(1, 6, 200).astype(np.float64)
    dup = np.concatenate([idx, idx[:7]], 0)
    dv = np.concatenate([vals, rng.integers(1, 6, 7).astype(np.float64)])
    plan = dg.fused_pair_plan(dup, dv, (30, 30))
    assert plan is not None
    s, m, keep = plan
    assert keep[:200].all() and not keep[200:].any()
    # same (s, m) as the strict encoder sees on the duplicate-free subset
    assert (s, m) == dg.fused_pair_encode(idx, vals, (30, 30))
    # the strict wrapper still declines the duplicated multiset
    assert dg.fused_pair_encode(dup, dv, (30, 30)) is None


def test_plan_tol_grid_bounded_error():
    """Continuous values engage only under an explicit tol, and the
    reconstruction error of every encoded observation respects it."""
    rng = np.random.default_rng(6)
    idx = _coo(rng, 30, 30, 400)
    cont = rng.standard_normal(400)
    assert dg.fused_pair_plan(idx, cont, (30, 30)) is None      # no tol
    tol = 0.05
    plan = dg.fused_pair_plan(idx, cont, (30, 30), tol=tol)
    assert plan is not None
    s, m, keep = plan
    assert s / 2.0 <= tol
    e = dg.encode_fused_values(cont[keep], s, m)
    assert e.dtype == np.int8 and (e != 0).all()
    recon = s * (e.astype(np.float64) + m)
    assert np.max(np.abs(recon - cont[keep])) <= tol + 1e-12
    # a tol below the achievable 255-level grid error declines
    assert dg.fused_pair_plan(idx, cont * 1000.0, (30, 30),
                              tol=tol) is None


def test_fused_int8_exact_fiber_bound():
    """The per-fiber |code|-sum bound admits sparse continuous grids the
    dense worst case wrongly declines, and still declines a genuinely
    overflowing hot fiber."""
    shape = (480_189, 17_770)
    assert not dg.fused_int8_ok(127, shape)          # dense worst case
    rng = np.random.default_rng(8)
    idx = _coo(rng, 500, 400, 5_000)
    codes = rng.integers(1, 128, 5_000).astype(np.float64)
    assert dg.fused_int8_ok(127, shape, idx=idx, abs_codes=codes)
    hot = np.stack([np.zeros(200_000, np.int64),
                    np.arange(200_000) % 400], 1)
    assert not dg.fused_int8_ok(127, shape, idx=hot,
                                abs_codes=np.full(200_000, 127.0))


def test_plan_full_grid_zero_code_residual():
    """A fully-populated 255-level exact grid has no free shift: the mid
    level's observations ride the residual and every stored code stays a
    nonzero int8 — exact math, where the strict encoder declines."""
    idx = _coo(np.random.default_rng(7), 30, 30, 255)
    vals = np.arange(255, dtype=np.float64)
    plan = dg.fused_pair_plan(idx, vals, (30, 30))
    assert plan is not None
    s, m, keep = plan
    e = dg.encode_fused_values(vals[keep], s, m)
    assert (e != 0).all() and np.abs(e.astype(np.int64)).max() <= 127
    np.testing.assert_allclose(s * (e.astype(np.float64) + m), vals[keep])
    assert (~keep).sum() == 1 and vals[~keep][0] == float(m) * s
    assert dg.fused_pair_encode(idx, vals, (30, 30)) is None


# ---------------------------------------------------------------------------
# fused_gram_contrib vs direct dense math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("focus_axis", [0, 1])
def test_fused_contrib_matches_direct(focus_axis):
    rng = np.random.default_rng(4 + focus_axis)
    n0, n1, K = 37, 23, 4
    nnz = 300
    idx = _coo(rng, n0, n1, nnz)
    vals = rng.integers(1, 6, nnz).astype(np.float64)
    mean = float(vals.mean())
    s, m = dg.fused_pair_encode(idx, vals, (n0, n1))
    V8 = dg.build_fused_values(idx, vals, (n0, n1), s, m)
    n_partner = n1 if focus_axis == 0 else n0
    n_focus = n0 if focus_axis == 0 else n1
    U = rng.standard_normal((n_partner, K))

    P, b = dg.fused_gram_contrib(
        jnp.asarray(V8), jnp.asarray(U), focus_axis,
        jnp.float64, jnp.float64, s, m, mean, row_chunks=5)
    P, b = np.asarray(P), np.asarray(b)

    # direct reference
    M = (V8 != 0).astype(np.float64)
    W = np.zeros((n0, n1))
    lin = idx[:, 0] * n1 + idx[:, 1]
    W.reshape(-1)[lin] = vals - mean
    if focus_axis == 1:
        M, W = M.T, W.T
    P_want = np.einsum("ap,pk,pl->akl", M, U, U)
    b_want = W @ U
    assert P.shape == (n_focus, K, K)
    np.testing.assert_allclose(P, P_want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(b, b_want, rtol=1e-9, atol=1e-9)


def test_fused_contrib_chunk_count_invariance():
    """Different row_chunks must give identical results in f64 (same math,
    chunked writes are disjoint; orientation-B partial sums reorder only
    at f64 scale)."""
    rng = np.random.default_rng(7)
    n0, n1, K = 41, 17, 3          # 41 is prime: exercises the tail chunk
    idx = _coo(rng, n0, n1, 200)
    vals = rng.integers(1, 6, 200).astype(np.float64)
    s, m = dg.fused_pair_encode(idx, vals, (n0, n1))
    V8 = dg.build_fused_values(idx, vals, (n0, n1), s, m)
    U = rng.standard_normal((n1, K))
    outs = [np.asarray(dg.fused_gram_contrib(
        jnp.asarray(V8), jnp.asarray(U), 0, jnp.float64, jnp.float64,
        s, m, 2.0, row_chunks=rc)[0]) for rc in (1, 4, 41, 64)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-12, atol=1e-12)


def test_device_build_chunked_matches_host(monkeypatch):
    """The chunked device scatter must equal the host build bit-for-bit,
    including OOB-dropped pad entries and the smaller tail chunk."""
    rng = np.random.default_rng(9)
    n0, n1 = 701, 37                    # odd sizes; prime row count
    lin = rng.choice(n0 * n1, 4000, replace=False)
    idx = np.stack([lin // n1, lin % n1], 1)
    vals = rng.integers(1, 6, 4000).astype(np.float64)
    s, m = dg.fused_pair_encode(idx, vals, (n0, n1))
    Vh = dg.build_fused_values(idx, vals, (n0, n1), s, m)
    monkeypatch.setattr(dg, "_SCATTER_CHUNK_NNZ", 500)  # force many chunks
    Vd = dg.build_fused_values_device(idx, vals, (n0, n1), s, m)
    assert (np.asarray(Vd) == Vh).all()


# ---------------------------------------------------------------------------
# fused s8 variant (fused_gram_contrib_i8 + contract/finish split)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("focus_axis", [0, 1])
def test_fused_i8_contrib_close_to_exact(focus_axis):
    """The quantized path must track the exact fused contraction within
    the per-column quantization step (|Y| <= 127 steps per column)."""
    rng = np.random.default_rng(51 + focus_axis)
    n0, n1, K = 37, 23, 4
    idx = _coo(rng, n0, n1, 300)
    vals = rng.integers(1, 6, 300).astype(np.float64)
    mean = float(vals.mean())
    s, m = dg.fused_pair_encode(idx, vals, (n0, n1))
    assert dg.fused_int8_ok(dg.fused_code_bound(vals, s, m), (n0, n1))
    V8 = dg.build_fused_values(idx, vals, (n0, n1), s, m)
    n_partner = n1 if focus_axis == 0 else n0
    U = rng.standard_normal((n_partner, K))
    P, b = dg.fused_gram_contrib(
        jnp.asarray(V8), jnp.asarray(U), focus_axis,
        jnp.float64, jnp.float64, s, m, mean)
    P8, b8 = dg.fused_gram_contrib_i8(
        jnp.asarray(V8), jnp.asarray(U), focus_axis,
        jnp.float64, s, m, mean)
    # quantization error ~ deg * step * |y|; 2% relative on this scale
    scale = float(np.max(np.abs(np.asarray(P))))
    np.testing.assert_allclose(np.asarray(P8), np.asarray(P),
                               atol=0.02 * scale)
    bs = float(np.max(np.abs(np.asarray(b))))
    np.testing.assert_allclose(np.asarray(b8), np.asarray(b),
                               atol=0.02 * bs)


@pytest.mark.parametrize("row_chunks", [1, 7, 64])
@pytest.mark.parametrize("focus_axis", [0, 1])
def test_fused_pair_contract_i8_matches_int64(focus_axis, row_chunks):
    """The chunked s8 x s8 -> int32 contraction equals the int64 NumPy
    product exactly, for every chunk count (tail chunk included): integer
    sums are exact whatever the order, which is what lets the sharded
    engine psum the raw partials."""
    rng = np.random.default_rng(61 + focus_axis)
    n0, n1, K = 41, 29, 5
    V8 = np.where(rng.random((n0, n1)) < 0.3,
                  rng.integers(-127, 128, (n0, n1)), 0).astype(np.int8)
    nc = n1 if focus_axis == 0 else n0
    C = K * (K + 1) // 2
    YZ8 = rng.integers(-127, 128, (nc, C + K)).astype(np.int8)
    Z8 = rng.integers(-127, 128, (nc, K)).astype(np.int8)
    PM, BV = dg.fused_pair_contract_i8(
        jnp.asarray(V8), jnp.asarray(YZ8), jnp.asarray(Z8), focus_axis,
        row_chunks=row_chunks)
    assert PM.dtype == jnp.int32 and BV.dtype == jnp.int32
    M = (V8 != 0).astype(np.int64)
    W = V8.astype(np.int64)
    if focus_axis == 1:
        M, W = M.T, W.T
    np.testing.assert_array_equal(np.asarray(PM), M @ YZ8.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(BV), W @ Z8.astype(np.int64))


@pytest.mark.parametrize("n_valid", [None, 23])
def test_fused_quantize_matches_numpy(n_valid):
    """Per-column symmetric int8 quantization of [triangle | factors]
    against a NumPy restatement: scale = max|col| / 127 over the valid
    prefix, codes = clip(round(x / scale)), Z8 = the trailing K columns."""
    rng = np.random.default_rng(97)
    n, K = 30, 4
    U = rng.standard_normal((n, K)).astype(np.float32)
    if n_valid is not None:
        U[n_valid:] *= 50.0            # pad rows must not move the scales
    YZ8, Z8, s_yz, s_z = dg.fused_quantize(jnp.asarray(U), n_valid)
    iu, ju = np.triu_indices(K)
    A = np.concatenate([U[:, iu] * U[:, ju], U], axis=1)
    Av = A if n_valid is None else A[:n_valid]
    sc = np.maximum(np.abs(Av).max(0) * np.float32(1.0 / 127.0),
                    np.finfo(np.float32).tiny).astype(np.float32)
    want = np.clip(np.round(A / sc), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(np.asarray(s_yz), sc)
    np.testing.assert_array_equal(np.asarray(s_z), sc[-K:])
    np.testing.assert_array_equal(np.asarray(YZ8), want)
    np.testing.assert_array_equal(np.asarray(Z8), want[:, -K:])


@pytest.mark.parametrize("path", ["pair", "fused"])
def test_alpha_folded_equals_alpha_after(path):
    """alpha folded into the s8 dequant scales (the engines' contract)
    equals alpha applied to the unscaled output, to f32 rounding — for
    the M/W pair path and the fused path, ridge included."""
    rng = np.random.default_rng(101)
    n0, n1, K = 37, 23, 4
    idx = _coo(rng, n0, n1, 300)
    vals = rng.integers(1, 6, 300).astype(np.float64)
    mean = float(vals.mean())
    U = jnp.asarray(rng.standard_normal((n1, K)), jnp.float32)
    deg = jnp.asarray(np.bincount(idx[:, 0], minlength=n0), jnp.float32)
    alpha = jnp.asarray(2.5, jnp.float32)
    if path == "pair":
        M, W = dg.build_dense_pair(idx, vals - mean, (n0, n1), np.float32)
        M8, W8, ws = dg.quantize_dense_pair(M, W)

        def run(a):
            return dg.dense_gram_contrib(
                jnp.asarray(M8), jnp.asarray(W8), [U], 0, (n0, n1),
                jnp.float32, jnp.float32, w_scale=ws, ridge_deg=deg,
                alpha=a)
    else:
        s, m = dg.fused_pair_encode(idx, vals, (n0, n1))
        V8 = jnp.asarray(dg.build_fused_values(idx, vals, (n0, n1), s, m))

        def run(a):
            return dg.fused_gram_contrib_i8(V8, U, 0, jnp.float32, s, m,
                                            mean, ridge_deg=deg, alpha=a)
    P_f, b_f = run(alpha)
    P_0, b_0 = run(None)
    sc = float(jnp.max(jnp.abs(P_0))) * 2.5
    np.testing.assert_allclose(np.asarray(P_f), 2.5 * np.asarray(P_0),
                               atol=1e-6 * sc, rtol=1e-6)
    sb = float(jnp.max(jnp.abs(b_0))) * 2.5
    np.testing.assert_allclose(np.asarray(b_f), 2.5 * np.asarray(b_0),
                               atol=1e-6 * sb, rtol=1e-6)


def test_fused_tol_ab_same_data_quality():
    """VERDICT r4 #5: pin the tol contract's quality cost with an A/B on
    the SAME jittered (continuous-valued) data — fused dense_fused_tol
    vs the exact-valued gather path.  The tol rounding perturbs only the
    latent rhs by <= tol per observation (~1e-4 in rmse² at tol=0.02),
    far below chain noise, so the two trajectories must agree closely;
    the netflix_cont headline gap (0.7586 vs 0.7055) is the DATA's
    jitter variance, not a tol-contract cost.  Also asserts the
    planner's deterministic contract: max grid-rounding error <= tol."""
    rng = np.random.default_rng(23)
    n0, n1, r = 300, 200, 4
    nnz = 12_000
    lin = rng.choice(n0 * n1, nnz, replace=False)
    idx = np.stack([lin // n1, lin % n1], 1)
    U = rng.standard_normal((n0, r)) / np.sqrt(r)
    V = rng.standard_normal((n1, r)) / np.sqrt(r)
    grid = np.clip(np.rint(3.0 + 2.0 * np.sum(U[idx[:, 0]] * V[idx[:, 1]],
                                              axis=1)), 1.0, 5.0)
    vals = grid + rng.uniform(-0.2, 0.2, nnz)      # continuous: no grid
    tol = 0.02
    plan = dg.fused_pair_plan(idx, vals, (n0, n1), tol=tol)
    assert plan is not None
    s, m, keep = plan
    q = np.rint(vals / s)
    assert np.max(np.abs(vals - s * q)) <= tol + 1e-12   # the contract
    rmses = {}
    for label, kw in (("tol", dict(dense_fused=True, dense_fused_tol=tol,
                                   dense_int8=True)),
                      ("exact", dict(dense_gram=False))):
        rd = bdf.RelationData.from_indexed_df(
            bdf.IndexedDF(idx, vals.copy(), (n0, n1)))
        rd.assign_to_test(0, 1500, seed=5)
        res = bdf.macau(rd, num_latent=r, burnin=15, psamples=15,
                        verbose=False, dtype="float64", seed=11, **kw)
        rmses[label] = res["RMSE"]
    if rmses["tol"] != rmses["tol"]:  # pragma: no cover
        raise AssertionError("NaN rmse")
    # both converge to the same quality; bound >> tol cost, << jitter arg
    assert abs(rmses["tol"] - rmses["exact"]) < 0.03, rmses


def test_engine_fused_i8_tracks_exact():
    """Engine-level: dense_int8 + fused relation engages the s8 variant
    (problem.fused_i8) and its short-chain RMSE trajectory tracks the
    exact fused path."""
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine

    rng = np.random.default_rng(71)
    n1, n2, r = 120, 90, 4
    U = rng.standard_normal((n1, r)) / np.sqrt(r)
    V = rng.standard_normal((n2, r)) / np.sqrt(r)
    mask = rng.random((n1, n2)) < 0.35
    idx = np.stack(np.nonzero(mask), 1)
    score = np.einsum("nk,nk->n", U[idx[:, 0]], V[idx[:, 1]]) * np.sqrt(r)
    vals = np.clip(np.rint(3.0 + score), 1.0, 5.0)
    df = bdf.IndexedDF(idx, vals, (n1, n2))
    rmses = {}
    for int8 in (False, True):
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 400, seed=7)
        cfg = MacauConfig(num_latent=4, burnin=10, psamples=0,
                          verbose=False, dtype="float32",
                          dense_gram=True, dense_fused=True,
                          dense_int8=int8, seed=42,
                          sweeps_per_dispatch=10)
        eng = MacauEngine(rd, cfg)
        assert eng.problem.fused_rels
        assert eng.problem.fused_i8.get(0, False) == int8
        out = eng.benchmark(10, repeats=1)
        rmses[int8] = float(out["metrics"]["r0.rmse_avg"])
    assert abs(rmses[True] - rmses[False]) < 0.03, rmses


# ---------------------------------------------------------------------------
# engine-level: fused plan engages and stays oracle-equivalent
# ---------------------------------------------------------------------------

def _grid_rd(rng, n1=22, n2=17, density=0.5):
    vals_grid = np.arange(1.0, 6.0)
    mask = rng.random((n1, n2)) < density
    idx = np.stack(np.nonzero(mask), 1)
    vals = rng.choice(vals_grid, idx.shape[0])
    df = bdf.IndexedDF(idx, vals, (n1, n2))
    return bdf.RelationData.from_indexed_df(df)


def test_engine_fused_plan_oracle_equiv():
    from tests.test_oracle_equiv import _run_equiv
    rng = np.random.default_rng(11)
    rd = _grid_rd(rng)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      dense_gram=True, dense_fused=True, seed=21)
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    eng = MacauEngine(rd, cfg)
    assert eng.problem.fused_rels, "fused path did not engage"
    assert all(p.kind == "fused" for p in eng.problem.dense_plans.values())
    _run_equiv(rd, cfg, n_sweeps=3)


def test_engine_hybrid_duplicates_oracle_equiv():
    """Hybrid fused relation (duplicates -> exact gather residual): the
    split accumulation is mathematically identical to one-path
    accumulation, so f64 oracle equivalence holds at 1e-8."""
    from tests.test_oracle_equiv import _run_equiv
    rng = np.random.default_rng(31)
    n1, n2 = 22, 17
    mask = rng.random((n1, n2)) < 0.5
    idx = np.stack(np.nonzero(mask), 1)
    vals = rng.choice(np.arange(1.0, 6.0), idx.shape[0])
    idx_d = np.concatenate([idx, idx[:9]], 0)
    vals_d = np.concatenate([vals, rng.choice(np.arange(1.0, 6.0), 9)])
    df = bdf.IndexedDF(idx_d, vals_d, (n1, n2))
    rd = bdf.RelationData.from_indexed_df(df)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      dense_gram=True, dense_fused=True, seed=33)
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    eng = MacauEngine(rd, cfg)
    assert eng.problem.fused_rels, "fused path did not engage"
    assert eng.problem.fused_keep, "hybrid residual did not engage"
    _run_equiv(rd, cfg, n_sweeps=3)


def test_engine_tol_grid_tracks_exact():
    """Bounded-error fused encoding (dense_fused_tol) on continuous
    values: short-chain RMSE tracks the exact dense-pair path within the
    contract's noise scale."""
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine

    rng = np.random.default_rng(73)
    n1, n2, r = 120, 90, 4
    U = rng.standard_normal((n1, r)) / np.sqrt(r)
    V = rng.standard_normal((n2, r)) / np.sqrt(r)
    mask = rng.random((n1, n2)) < 0.35
    idx = np.stack(np.nonzero(mask), 1)
    score = np.einsum("nk,nk->n", U[idx[:, 0]], V[idx[:, 1]]) * np.sqrt(r)
    vals = 3.0 + score + 0.05 * rng.standard_normal(idx.shape[0])
    df = bdf.IndexedDF(idx, vals, (n1, n2))
    rmses = {}
    for fused in (False, True):
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 400, seed=7)
        cfg = MacauConfig(num_latent=4, burnin=10, psamples=0,
                          verbose=False, dtype="float32",
                          dense_gram=True,
                          dense_fused=True if fused else False,
                          dense_fused_tol=0.02 if fused else None,
                          seed=42, sweeps_per_dispatch=10)
        eng = MacauEngine(rd, cfg)
        if fused:
            assert eng.problem.fused_rels, "tol grid did not engage"
        out = eng.benchmark(10, repeats=1)
        rmses[fused] = float(out["metrics"]["r0.rmse_avg"])
    assert abs(rmses[True] - rmses[False]) < 0.03, rmses


def test_engine_fused_auto_declines_when_pair_fits():
    """Auto mode must prefer the (faster) pair path when it fits."""
    rng = np.random.default_rng(12)
    rd = _grid_rd(rng)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      dense_gram=True, seed=22)
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    eng = MacauEngine(rd, cfg)
    assert not eng.problem.fused_rels
