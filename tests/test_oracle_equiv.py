"""RNG-injection equivalence: the device engine vs the NumPy f64 oracle.

SURVEY.md §6/§9.5: both consume the SAME randoms pytree; per-sweep factor
updates must match to float64 tolerance.  This is the contract standing in
for "reproduce the reference's per-sweep factor updates exactly given
identical RNG streams" (BASELINE.json north_star).
"""
import numpy as np
import pytest

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
from bayesiandatafusion_jl_tpu.utils.rng import draw_all_numpy
from oracle.oracle import OracleMacau

import jax


def _run_equiv(rd, cfg, n_sweeps=3, rtol=1e-8, check_beta=False,
               check_alpha=False):
    eng = MacauEngine(rd, cfg)
    oracle = OracleMacau(rd, cfg)

    key = jax.random.key(cfg.seed)
    state = eng.init_state(jax.random.fold_in(key, 0))
    ost = oracle.init_state([np.asarray(e["U"], np.float64)
                             for e in state["ent"]])

    rng = np.random.default_rng(999)
    for s in range(n_sweeps):
        randoms = draw_all_numpy(rng, eng.problem.random_spec)
        jrandoms = {k: jax.numpy.asarray(v) for k, v in randoms.items()}
        state, _ = eng._sweep_randoms_jit(eng.problem.arrays, state,
                                          jrandoms, 0.0)
        oracle.sweep(ost, randoms)
        for ei in range(len(rd.entities)):
            np.testing.assert_allclose(
                np.asarray(state["ent"][ei]["U"]), ost.U[ei], rtol=rtol,
                atol=rtol, err_msg=f"U mismatch sweep {s} entity {ei}")
            np.testing.assert_allclose(
                np.asarray(state["ent"][ei]["mu"]), ost.mu[ei], rtol=rtol,
                atol=rtol, err_msg=f"mu mismatch sweep {s} entity {ei}")
            np.testing.assert_allclose(
                np.asarray(state["ent"][ei]["Lambda"]), ost.Lambda[ei],
                rtol=rtol, atol=rtol,
                err_msg=f"Lambda mismatch sweep {s} entity {ei}")
            if check_beta and "beta" in state["ent"][ei]:
                np.testing.assert_allclose(
                    np.asarray(state["ent"][ei]["beta"]), ost.beta[ei],
                    rtol=rtol, atol=rtol,
                    err_msg=f"beta mismatch sweep {s} entity {ei}")
                np.testing.assert_allclose(
                    float(state["ent"][ei]["lambda_beta"]),
                    ost.lambda_beta[ei], rtol=rtol,
                    err_msg=f"lambda_beta mismatch sweep {s}")
        if check_alpha:
            for ri in range(len(rd.relations)):
                np.testing.assert_allclose(
                    float(state["rel"][ri]["alpha"]), ost.alpha[ri],
                    rtol=rtol, err_msg=f"alpha mismatch sweep {s} rel {ri}")


def _matrix_rd(rng, n1=22, n2=17, density=0.5, **rd_kwargs):
    R = rng.standard_normal((n1, n2))
    mask = rng.random((n1, n2)) < density
    idx = np.stack(np.nonzero(mask), 1)
    df = bdf.IndexedDF(idx, R[mask], (n1, n2))
    return bdf.RelationData.from_matrix(df, **rd_kwargs)


def test_bpmf_equivalence():
    rng = np.random.default_rng(0)
    rd = _matrix_rd(rng)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64", seed=11)
    _run_equiv(rd, cfg, n_sweeps=3)


def test_bpmf_equivalence_with_head_chunking():
    # one very dense column forces chunked accumulation across buckets
    rng = np.random.default_rng(4)
    n1, n2 = 64, 9
    R = rng.standard_normal((n1, n2))
    mask = rng.random((n1, n2)) < 0.4
    mask[:, 0] = True  # head instance: degree 64 > widest test bucket
    idx = np.stack(np.nonzero(mask), 1)
    df = bdf.IndexedDF(idx, R[mask], (n1, n2))
    rd = bdf.RelationData.from_indexed_df(df)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      bucket_widths=(4, 16), seed=12)
    _run_equiv(rd, cfg, n_sweeps=2)


def test_macau_ff_equivalence():
    rng = np.random.default_rng(1)
    feat = (rng.random((22, 13)) < 0.3).astype(np.float64)
    rd = _matrix_rd(rng, feat1=feat)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      use_ff=True, seed=13)
    _run_equiv(rd, cfg, n_sweeps=3, check_beta=True)


def test_macau_cg_equivalence():
    rng = np.random.default_rng(2)
    feat = (rng.random((22, 13)) < 0.3).astype(np.float64)
    rd = _matrix_rd(rng, feat1=feat)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      use_ff=False, cg_tol=1e-12, seed=14)
    # CG converges to solver tolerance, not machine eps
    _run_equiv(rd, cfg, n_sweeps=3, rtol=1e-6, check_beta=True)


def test_macau_realvalued_features_ff_equivalence():
    """Real-valued (non-binary) side information — standardized features —
    must flow through the FF path unmodified (round-1 gap: features were
    silently binarized; SURVEY §3 Entity row, §4.4)."""
    rng = np.random.default_rng(8)
    feat = rng.standard_normal((22, 13)) * (rng.random((22, 13)) < 0.4)
    rd = _matrix_rd(rng, feat1=feat)
    assert not rd.entities[0].F.is_binary
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      use_ff=True, seed=24)
    _run_equiv(rd, cfg, n_sweeps=3, check_beta=True)


def test_macau_realvalued_features_cg_equivalence():
    """Real-valued side info through the blocked-CG path (weighted matvec
    + squared-value Jacobi preconditioner)."""
    rng = np.random.default_rng(9)
    feat = rng.standard_normal((22, 13)) * (rng.random((22, 13)) < 0.4)
    rd = _matrix_rd(rng, feat1=feat)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      use_ff=False, cg_tol=1e-12, seed=25)
    _run_equiv(rd, cfg, n_sweeps=3, rtol=1e-6, check_beta=True)


def test_tensor_equivalence():
    rng = np.random.default_rng(3)
    shape = (9, 8, 5)
    T = rng.standard_normal(shape)
    mask = rng.random(shape) < 0.4
    idx = np.stack(np.nonzero(mask), 1)
    df = bdf.IndexedDF(idx, T[mask], shape)
    rd = bdf.RelationData.from_indexed_df(df)
    cfg = MacauConfig(num_latent=2, verbose=False, dtype="float64", seed=15)
    _run_equiv(rd, cfg, n_sweeps=2)


def test_multirelation_alpha_equivalence():
    rng = np.random.default_rng(5)
    nc, nt, na = 15, 12, 7
    e_c, e_t, e_a = (bdf.Entity(n, count=c)
                     for n, c in [("c", nc), ("t", nt), ("a", na)])
    rd = bdf.RelationData()
    for name, ents, shp in [("r1", [e_c, e_t], (nc, nt)),
                            ("r2", [e_c, e_a], (nc, na))]:
        R = rng.standard_normal(shp)
        mask = rng.random(shp) < 0.5
        rd.add_relation(
            bdf.IndexedDF(np.stack(np.nonzero(mask), 1), R[mask], shp),
            name, ents)
    rd.set_precision("r1", 5.0, sample=True)
    rd.set_precision("r2", 2.0, sample=True)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64", seed=16)
    _run_equiv(rd, cfg, n_sweeps=3, check_alpha=True)


def test_symmetric_relation_equivalence():
    """Same entity on both modes (e.g. drug x drug interaction): each mode
    gets its own layout; partner gathers read the entity's own current
    factors.  Engine must match the oracle exactly."""
    rng = np.random.default_rng(6)
    n = 18
    mask = rng.random((n, n)) < 0.4
    np.fill_diagonal(mask, False)
    idx = np.stack(np.nonzero(mask), 1)
    df = bdf.IndexedDF(idx, rng.standard_normal(idx.shape[0]), (n, n))
    e = bdf.Entity("drug", count=n)
    rd = bdf.RelationData()
    rd.add_relation(df, "interaction", [e, e])
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64", seed=19)
    _run_equiv(rd, cfg, n_sweeps=3)


def test_dense_gram_equivalence():
    """accumulation via dense M @ Y matmuls (ops/dense_gram.py) must
    match the oracle exactly — same per-observation semantics, different
    summation order only."""
    rng = np.random.default_rng(31)
    rd = _matrix_rd(rng)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      dense_gram=True, seed=31)
    _run_equiv(rd, cfg, n_sweeps=3)


def test_dense_gram_tensor_equivalence():
    """3-way tensor through the dense path: every mode contracts the
    shared canonical tensor with a multi-operand einsum (leading, middle,
    and trailing focus axes)."""
    rng = np.random.default_rng(32)
    shape = (9, 8, 5)
    T = rng.standard_normal(shape)
    mask = rng.random(shape) < 0.4
    idx = np.stack(np.nonzero(mask), 1)
    df = bdf.IndexedDF(idx, T[mask], shape)
    rd = bdf.RelationData.from_indexed_df(df)
    cfg = MacauConfig(num_latent=2, verbose=False, dtype="float64",
                      dense_gram=True, seed=32)
    eng_probe = MacauEngine(rd, cfg)
    kinds = {m: p.kind for (_, m), p in eng_probe.problem.dense_plans.items()}
    assert kinds == {0: "canonical", 1: "canonical", 2: "canonical"}
    _run_equiv(rd, cfg, n_sweeps=2)


def test_dense_gram_multirelation_equivalence():
    """Fusion graph + sampled alpha with every mode dense: the shared
    entity accumulates dense contributions from two relations."""
    rng = np.random.default_rng(33)
    nc, nt, na = 15, 12, 7
    e_c, e_t, e_a = (bdf.Entity(n, count=c)
                     for n, c in [("c", nc), ("t", nt), ("a", na)])
    rd = bdf.RelationData()
    for name, ents, shp in [("r1", [e_c, e_t], (nc, nt)),
                            ("r2", [e_c, e_a], (nc, na))]:
        R = rng.standard_normal(shp)
        mask = rng.random(shp) < 0.5
        rd.add_relation(
            bdf.IndexedDF(np.stack(np.nonzero(mask), 1), R[mask], shp),
            name, ents)
    rd.set_precision("r1", 5.0, sample=True)
    rd.set_precision("r2", 2.0, sample=True)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      dense_gram=True, seed=33)
    _run_equiv(rd, cfg, n_sweeps=3, check_alpha=True)


def test_dense_gram_symmetric_and_degree_zero():
    """Dense path with the same entity on both modes and empty rows/cols
    (degree-zero instances fall back to the prior via an all-zero M row)."""
    rng = np.random.default_rng(34)
    n = 18
    mask = rng.random((n, n)) < 0.4
    np.fill_diagonal(mask, False)
    mask[4, :] = False
    mask[:, 4] = False
    idx = np.stack(np.nonzero(mask), 1)
    df = bdf.IndexedDF(idx, rng.standard_normal(idx.shape[0]), (n, n))
    e = bdf.Entity("drug", count=n)
    rd = bdf.RelationData()
    rd.add_relation(df, "interaction", [e, e])
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      dense_gram=True, seed=34)
    _run_equiv(rd, cfg, n_sweeps=3)


def test_dense_feat_cg_equivalence():
    """Dense [N, F] feature operand for the beta CG matvec (use_dense_feat)
    — same operator as the bucketed spmm up to summation order, so the CG
    draw matches the oracle to solver tolerance."""
    rng = np.random.default_rng(35)
    feat = (rng.random((22, 13)) < 0.3).astype(np.float64)
    rd = _matrix_rd(rng, feat1=feat)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      use_ff=False, cg_tol=1e-12, dense_gram=True, seed=35)
    eng = MacauEngine(rd, cfg)
    assert "dense_X" in eng.problem.arrays["feat"]["e0"]
    _run_equiv(rd, cfg, n_sweeps=3, rtol=1e-6, check_beta=True)


def test_degree_zero_instances_equivalence():
    """Instances with NO observations must sample from the prior
    N(mu, Lambda^{-1}) — P = Lambda path, no NaNs, matches oracle."""
    rng = np.random.default_rng(7)
    n1, n2 = 20, 14
    mask = rng.random((n1, n2)) < 0.4
    mask[3, :] = False   # empty row
    mask[:, 5] = False   # empty column
    mask[0, 0] = True    # keep nnz > 0
    idx = np.stack(np.nonzero(mask), 1)
    df = bdf.IndexedDF(idx, rng.standard_normal(idx.shape[0]), (n1, n2))
    rd = bdf.RelationData.from_indexed_df(df)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64", seed=23)
    _run_equiv(rd, cfg, n_sweeps=3)


def test_macau_dual_equivalence():
    """Woodbury dual solver (ops/dual.py) is an exact direct solve: it
    matches the oracle's np.linalg.solve at direct-solve tolerance (the
    CG path only reaches solver tolerance)."""
    rng = np.random.default_rng(40)
    feat = (rng.random((22, 30)) < 0.2).astype(np.float64)  # N < F
    rd = _matrix_rd(rng, feat1=feat)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      beta_solver="dual", use_ff=False, seed=41)
    _run_equiv(rd, cfg, n_sweeps=3, rtol=1e-8, check_beta=True)


def test_dual_eig_cache_roundtrip(tmp_path):
    """dual_eig_cached: second call returns the stored (Q, d) exactly."""
    from bayesiandatafusion_jl_tpu.ops.dual import dual_eig_cached
    rng = np.random.default_rng(7)
    rows, cols = np.nonzero(rng.random((12, 20)) < 0.3)
    vals = rng.random(rows.shape[0])
    a = dual_eig_cached(rows, cols, vals, (12, 20), np.float64,
                        str(tmp_path))
    assert len(list(tmp_path.glob("dualeig_*.npz"))) == 1
    b = dual_eig_cached(rows, cols, vals, (12, 20), np.float64,
                        str(tmp_path))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    # different values => different key
    dual_eig_cached(rows, cols, vals + 1.0, (12, 20), np.float64,
                    str(tmp_path))
    assert len(list(tmp_path.glob("dualeig_*.npz"))) == 2


def test_macau_dual_realvalued_equivalence():
    rng = np.random.default_rng(42)
    feat = np.where(rng.random((22, 30)) < 0.2,
                    rng.standard_normal((22, 30)), 0.0)
    rd = _matrix_rd(rng, feat1=feat)
    cfg = MacauConfig(num_latent=3, verbose=False, dtype="float64",
                      beta_solver="dual", use_ff=False, seed=43)
    _run_equiv(rd, cfg, n_sweeps=3, rtol=1e-8, check_beta=True)
