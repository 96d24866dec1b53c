"""Integration tests for the Gibbs engine (reference test strategy,
SURVEY.md §6: run the real thing on small synthetic data, assert RMSE is
finite/improving; FF and CG side-info paths agree; tensor and
multi-relation smoke; plus stricter determinism/resume checks the
reference never had)."""
import jax
import numpy as np
import pytest

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.engine import MacauEngine, _auc
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig


def _lowrank_matrix(rng, n1, n2, k, noise=0.1, density=0.5):
    U = rng.standard_normal((n1, k))
    V = rng.standard_normal((n2, k))
    R = U @ V.T + noise * rng.standard_normal((n1, n2))
    mask = rng.random((n1, n2)) < density
    idx = np.stack(np.nonzero(mask), 1)
    return bdf.IndexedDF(idx, R[mask], (n1, n2))


def test_bpmf_recovers_low_rank():
    rng = np.random.default_rng(0)
    df = _lowrank_matrix(rng, 60, 45, 4)
    rd = bdf.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 200)
    res = bdf.macau(rd, num_latent=4, burnin=20, psamples=20,
                    verbose=False, dtype="float32")
    assert np.isfinite(res["RMSE"])
    assert res["RMSE"] < 0.5  # noise floor is 0.1
    p = res["predictions"]
    assert p["pred"].shape == (200,) and p["stdev"].shape == (200,)


def test_macau_ff_cg_agree():
    rng = np.random.default_rng(1)
    n1, n2, k, f = 50, 35, 3, 20
    feat = (rng.random((n1, f)) < 0.2).astype(np.float64)
    U = feat @ (rng.standard_normal((f, k))) + 0.2 * rng.standard_normal((n1, k))
    V = rng.standard_normal((n2, k))
    R = U @ V.T + 0.1 * rng.standard_normal((n1, n2))
    mask = rng.random((n1, n2)) < 0.5
    df = bdf.IndexedDF(np.stack(np.nonzero(mask), 1), R[mask], (n1, n2))
    rmses = {}
    for use_ff in (True, False):
        rd = bdf.RelationData.from_matrix(df, feat1=feat)
        rd.assign_to_test(0, 150, seed=3)
        cfg = MacauConfig(num_latent=3, burnin=10, psamples=10,
                          verbose=False, dtype="float64", use_ff=use_ff,
                          seed=7)
        rmses[use_ff] = MacauEngine(rd, cfg).run()["RMSE"]
    # identical RNG streams + exact/near-exact solves -> near-identical
    assert abs(rmses[True] - rmses[False]) < 1e-3


def test_tensor_smoke():
    rng = np.random.default_rng(2)
    shape = (20, 15, 5)
    k = 3
    Us = [rng.standard_normal((n, k)) for n in shape]
    T = np.einsum("ik,jk,ck->ijc", *Us) + 0.1 * rng.standard_normal(shape)
    mask = rng.random(shape) < 0.4
    df = bdf.IndexedDF(np.stack(np.nonzero(mask), 1), T[mask], shape)
    rd = bdf.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 150)
    res = bdf.macau(rd, num_latent=3, burnin=15, psamples=15,
                    verbose=False, dtype="float32")
    assert np.isfinite(res["RMSE"]) and res["RMSE"] < 2.0


def test_multirelation_improves_sparse_side():
    """Fusing a dense auxiliary relation must help a very sparse target."""
    rng = np.random.default_rng(3)
    nc, nt, na, k = 50, 30, 25, 3
    Uc = rng.standard_normal((nc, k))
    R1 = Uc @ rng.standard_normal((k, nt)) + 0.1 * rng.standard_normal((nc, nt))
    R2 = Uc @ rng.standard_normal((k, na)) + 0.1 * rng.standard_normal((nc, na))
    m1 = rng.random((nc, nt)) < 0.15  # sparse target

    def run(with_aux):
        c = bdf.Entity("c", count=nc)
        t = bdf.Entity("t", count=nt)
        rd = bdf.RelationData()
        rd.add_relation(bdf.IndexedDF(np.stack(np.nonzero(m1), 1),
                                      R1[m1], (nc, nt)), "target", [c, t])
        if with_aux:
            a = bdf.Entity("a", count=na)
            m2 = rng.random((nc, na)) < 0.8
            rd.add_relation(bdf.IndexedDF(np.stack(np.nonzero(m2), 1),
                                          R2[m2], (nc, na)), "aux", [c, a])
        rd.assign_to_test("target", 60, seed=5)
        res = bdf.macau(rd, num_latent=3, burnin=15, psamples=15,
                        verbose=False, dtype="float32", seed=11)
        return res["target"]["RMSE"]

    # not asserting strict improvement (MCMC noise) — but fused must not be
    # drastically worse, and both finite
    r_alone, r_fused = run(False), run(True)
    assert np.isfinite(r_alone) and np.isfinite(r_fused)
    assert r_fused < r_alone * 1.5


def test_determinism_same_seed():
    rng = np.random.default_rng(4)
    df = _lowrank_matrix(rng, 30, 20, 3)
    rd1 = bdf.RelationData.from_indexed_df(df)
    rd1.assign_to_test(0, 50, seed=1)
    cfg = MacauConfig(num_latent=3, burnin=5, psamples=5, verbose=False,
                      dtype="float32", seed=99)
    r1 = MacauEngine(rd1, cfg).run()
    rd2 = bdf.RelationData.from_indexed_df(df)
    rd2.assign_to_test(0, 50, seed=1)
    r2 = MacauEngine(rd2, cfg).run()
    assert r1["RMSE"] == r2["RMSE"]
    np.testing.assert_array_equal(r1["predictions"]["pred"],
                                  r2["predictions"]["pred"])


def test_checkpoint_resume_exact(tmp_path):
    rng = np.random.default_rng(5)
    df = _lowrank_matrix(rng, 25, 18, 3)
    rd = bdf.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 40, seed=2)
    cfg = MacauConfig(num_latent=3, burnin=4, psamples=4, verbose=False,
                      dtype="float32", seed=17)
    eng = MacauEngine(rd, cfg)
    key = jax.random.key(cfg.seed)
    full = eng.run(state=eng.init_state(jax.random.fold_in(key, 0)), key=key)

    from bayesiandatafusion_jl_tpu.utils.rng import sweep_key
    st = eng.init_state(jax.random.fold_in(key, 0))
    for s in range(4):
        st, _ = eng._sweep_jit(eng.problem.arrays, st, sweep_key(key, s + 1),
                               0.0)
    path = str(tmp_path / "ckpt.npz")
    eng.save_state(path, st, 4)
    st2, sweep = eng.load_state(path)
    resumed = eng.run(state=st2, key=key, sweep_offset=sweep)
    assert full["RMSE"] == resumed["RMSE"]


def test_clamp_applied_per_sample():
    rng = np.random.default_rng(6)
    df = _lowrank_matrix(rng, 30, 20, 3)
    rd = bdf.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 60)
    res = bdf.macau(rd, num_latent=3, burnin=3, psamples=3,
                    clamp=[-0.5, 0.5], verbose=False, dtype="float32")
    p = res["predictions"]["pred"]
    assert p.min() >= -0.5 - 1e-6 and p.max() <= 0.5 + 1e-6


def test_alpha_sampling_tracks_noise():
    # alpha should land near the true precision 1/noise^2
    rng = np.random.default_rng(7)
    noise = 0.5
    df = _lowrank_matrix(rng, 60, 40, 3, noise=noise, density=0.6)
    rd = bdf.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 100)
    rd.set_precision(0, 1.0, sample=True)
    cfg = MacauConfig(num_latent=3, burnin=25, psamples=10, verbose=False,
                      dtype="float32", alpha_sample=True)
    eng = MacauEngine(rd, cfg)
    res = eng.run()
    alpha = float(np.asarray(res["state"]["rel"][0]["alpha"]))
    assert 0.3 / noise**2 < alpha < 3.0 / noise**2


def test_auc_helper():
    labels = np.array([True, True, False, False])
    scores = np.array([0.9, 0.8, 0.2, 0.1])
    assert _auc(labels, scores) == 1.0
    assert _auc(labels, -scores) == 0.0
    assert _auc(labels, np.ones(4)) == 0.5


def test_auc_device_matches_host_on_ties():
    """Device AUC must use midranks so tied predictions (class_cut
    workloads) score identically to the host _auc."""
    from bayesiandatafusion_jl_tpu.models.engine import auc_device
    import jax.numpy as jnp
    rng = np.random.default_rng(8)
    labels = rng.random(200) < 0.4
    # heavily tied scores: quantized to 5 levels
    scores = np.round(rng.random(200) * 4) / 4.0
    want = _auc(labels, scores)
    got = float(auc_device(jnp.asarray(labels, jnp.float64),
                           jnp.asarray(scores)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # and on the untied case too
    scores2 = rng.standard_normal(200)
    np.testing.assert_allclose(
        float(auc_device(jnp.asarray(labels, jnp.float64),
                         jnp.asarray(scores2))),
        _auc(labels, scores2), rtol=1e-12)


def test_predictions_frame_roundtrip():
    from bayesiandatafusion_jl_tpu.models.engine import predictions_frame
    rng = np.random.default_rng(9)
    df = _lowrank_matrix(rng, 30, 20, 3)
    rd = bdf.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 50)
    res = bdf.macau(rd, num_latent=3, burnin=5, psamples=5, verbose=False,
                    dtype="float32")
    frame = predictions_frame(res)
    assert list(frame.columns) == ["idx0", "idx1", "obs", "pred", "stdev"]
    assert len(frame) == 50
    np.testing.assert_allclose(frame["pred"].to_numpy(),
                               res["predictions"]["pred"])
    # named-relation selection
    frame2 = predictions_frame(res, relation="rel")
    np.testing.assert_array_equal(frame2.to_numpy(), frame.to_numpy())


def test_predict_out_of_matrix(tmp_path):
    """Reference README flagship reuse workflow (SURVEY §7.4): score NEW
    compounds from saved posterior samples via beta/mu."""
    from bayesiandatafusion_jl_tpu.models.engine import predict_out_of_matrix
    rng = np.random.default_rng(10)
    n1, n2, k, f = 60, 30, 3, 12
    feat_all = (rng.random((n1 + 10, f)) < 0.4).astype(np.float64)
    W = rng.standard_normal((f, k))
    U_all = feat_all @ W          # latent fully driven by side info
    V = rng.standard_normal((n2, k))
    R_train = U_all[:n1] @ V.T + 0.05 * rng.standard_normal((n1, n2))
    mask = rng.random((n1, n2)) < 0.7
    df = bdf.IndexedDF(np.stack(np.nonzero(mask), 1), R_train[mask],
                       (n1, n2))
    rd = bdf.RelationData.from_matrix(df, feat1=feat_all[:n1])
    rd.assign_to_test(0, 100, seed=1)
    prefix = str(tmp_path / "oom")
    mean_r = float(rd.relations[0].data.vals.mean())
    res = bdf.macau(rd, num_latent=k, burnin=30, psamples=10, verbose=False,
                    dtype="float64", use_ff=True, seed=3,
                    output_prefix=prefix)
    x_new = feat_all[n1:]
    preds = predict_out_of_matrix(prefix, x_new, relation_mean=mean_r)
    assert preds.shape == (10, n2)
    truth = U_all[n1:] @ V.T
    resid = preds - truth
    # out-of-matrix predictions must track the side-info-driven truth
    assert np.sqrt(np.mean(resid ** 2)) < 0.5 * truth.std(), \
        (np.sqrt(np.mean(resid ** 2)), truth.std())


def test_bf16_gramian_close_to_f32():
    """gram_dtype=bfloat16 must not meaningfully change results (it only
    affects the Gramian contraction inputs; accumulation stays f32)."""
    rng = np.random.default_rng(12)
    df = _lowrank_matrix(rng, 60, 45, 4)
    def run(gd):
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 150, seed=3)
        cfg = MacauConfig(num_latent=4, burnin=10, psamples=10,
                          verbose=False, dtype="float32", gram_dtype=gd,
                          seed=31)
        return MacauEngine(rd, cfg).run()["RMSE"]
    r32, rb = run(None), run("bfloat16")
    assert abs(r32 - rb) < 0.05, (r32, rb)


def test_int8_feature_slab_close_to_f32():
    """Binary side info + gram_dtype=bfloat16 stores the dense feature
    operand as int8 (exact 0/1; the convert fuses into the CG matvec) and
    must track the f32 gather path."""
    rng = np.random.default_rng(21)
    n1, n2, k, f = 70, 40, 4, 50
    feat = (rng.random((n1, f)) < 0.2).astype(np.float64)
    beta = rng.standard_normal((f, k)) * 0.3
    U = feat @ beta + 0.3 * rng.standard_normal((n1, k))
    V = rng.standard_normal((n2, k))
    R = U @ V.T + 0.1 * rng.standard_normal((n1, n2))
    mask = rng.random((n1, n2)) < 0.6
    df = bdf.IndexedDF(np.stack(np.nonzero(mask), 1), R[mask], (n1, n2))

    def run(gd, dense):
        rd = bdf.RelationData.from_matrix(df, feat1=feat)
        rd.assign_to_test(0, 150, seed=3)
        cfg = MacauConfig(num_latent=k, burnin=8, psamples=8, verbose=False,
                          dtype="float32", gram_dtype=gd, dense_gram=dense,
                          use_ff=False, seed=17)
        eng = MacauEngine(rd, cfg)
        if dense:
            import jax.numpy as jnp
            xd = eng.problem.arrays["feat"]["e0"]["dense_X"]
            assert xd.dtype == (jnp.int8 if gd == "bfloat16"
                                else jnp.float32), xd.dtype
        return eng.run()["RMSE"]

    r32, ri8 = run(None, False), run("bfloat16", True)
    assert abs(r32 - ri8) < 0.05, (r32, ri8)


def test_dense_int8_close_to_f32():
    """dense_int8: int8-stored M/W + per-column-quantized Y/V must track
    the f32 dense path closely (quantization noise is the same order as
    gram_dtype='bfloat16' rounding)."""
    rng = np.random.default_rng(23)
    n1, n2, k = 90, 70, 4
    U = rng.standard_normal((n1, k))
    V = rng.standard_normal((n2, k))
    R = U @ V.T / np.sqrt(k) + 0.2 * rng.standard_normal((n1, n2))
    mask = rng.random((n1, n2)) < 0.5
    df = bdf.IndexedDF(np.stack(np.nonzero(mask), 1), R[mask], (n1, n2))

    def run(int8):
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 300, seed=3)
        cfg = MacauConfig(num_latent=k, burnin=10, psamples=10,
                          verbose=False, dtype="float32", dense_gram=True,
                          dense_int8=int8, seed=17)
        eng = MacauEngine(rd, cfg)
        if int8:
            import jax.numpy as jnp
            st = eng.problem.arrays["dense"]["r0"]
            assert st["M"].dtype == jnp.int8 and st["W"].dtype == jnp.int8
            assert eng.problem.dense_w_scale.get(0)
        return eng.run()["RMSE"]

    r32, r8 = run(False), run(True)
    assert abs(r32 - r8) < 0.02, (r32, r8)


def test_dense_plan_fires_at_high_rank():
    """The auto dense-plan gather estimate scales ~K^2 like the dense
    contraction's packed triangle, so a relation dense enough for the
    dense path at K=32 keeps it at K=96 (fusion-graph IC50 shape, 20%
    observed); tiny problems stay on the gather path."""
    from bayesiandatafusion_jl_tpu.ops.dense_gram import (estimate_times,
                                                          plan_dense_modes)
    shape, nnz = (50_000, 500), 4_900_000
    for K in (32, 96):
        plans, _, _ = plan_dense_modes([shape], [nnz], K, None, 9e9, 2)
        assert (0, 0) in plans and (0, 1) in plans, (K, plans.keys())
    g32 = estimate_times(shape[0], shape[1], nnz, 32, 1)[1]
    g96 = estimate_times(shape[0], shape[1], nnz, 96, 1)[1]
    assert abs(g96 / g32 - 9.0) < 1e-9
    # tiny problems still stay on the gather path (test-suite seam)
    plans, _, _ = plan_dense_modes([(50, 40)], [1000], 32, None, 9e9, 2)
    assert not plans


def test_dense_gram_contrib_int8_close():
    """Unit closeness of the quantized contraction against the f32 one."""
    import jax.numpy as jnp

    from bayesiandatafusion_jl_tpu.ops import dense_gram as dg
    rng = np.random.default_rng(29)
    n, np_, k = 40, 30, 5
    idx = np.stack(np.nonzero(rng.random((n, np_)) < 0.4), 1)
    vals = rng.standard_normal(idx.shape[0])
    M, W = dg.build_dense_pair(idx, vals, (n, np_), np.float32)
    Up = jnp.asarray(rng.standard_normal((np_, k)), jnp.float32)
    # copies: quantize_dense_pair consumes W in place, and jnp.asarray of
    # host f32 is a zero-copy alias on the CPU backend
    P0, b0 = dg.dense_gram_contrib(jnp.asarray(M.copy()),
                                   jnp.asarray(W.copy()), [Up],
                                   0, (n, np_), jnp.float32, jnp.float32)
    M8, W8, ws = dg.quantize_dense_pair(M, W)
    P1, b1 = dg.dense_gram_contrib(jnp.asarray(M8), jnp.asarray(W8), [Up],
                                   0, (n, np_), jnp.float32, jnp.float32,
                                   w_scale=ws)
    np.testing.assert_allclose(P1, P0, atol=0.02 * float(jnp.abs(P0).max()))
    np.testing.assert_allclose(b1, b0, atol=0.03 * float(jnp.abs(b0).max()))


def test_native_dense_pair_matches_numpy():
    """C++ accumulate/quantize fast paths (native/layout.cpp) must be
    bitwise equal to the NumPy fallbacks, including mode permutations."""
    from bayesiandatafusion_jl_tpu import native
    from bayesiandatafusion_jl_tpu.ops import dense_gram as dg
    if native.lib() is None:
        import pytest
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(31)
    idx = np.stack([rng.integers(0, 30, 2000), rng.integers(0, 20, 2000),
                    rng.integers(0, 7, 2000)], 1).astype(np.int32)
    cen = rng.standard_normal(2000)
    for perm in (None, (1, 0, 2), (2, 0, 1)):
        Mn, Wn = dg.build_dense_pair(idx, cen, (30, 20, 7), np.float32,
                                     perm=perm)
        Mp = dg._accum_dense_pair_native(
            idx, cen, ([30, 20, 7] if perm is None
                       else [(30, 20, 7)[p] for p in perm]),
            perm, Mn.size)
        assert Mp is not None
        np.testing.assert_array_equal(Mp[0].reshape(Mn.shape), Mn)
        np.testing.assert_array_equal(Mp[1].reshape(Wn.shape), Wn)
        M8n, W8n, wsn = dg._quantize_pair_native(Mn, Wn)
        w_max = float(np.abs(Wn).max())
        ws = (w_max / 127.0) or 1.0
        W8_ref = np.clip(np.rint(Wn / np.float32(ws)),
                         -127, 127).astype(np.int8)
        assert wsn == ws
        np.testing.assert_array_equal(W8n, W8_ref)
        np.testing.assert_array_equal(M8n, Mn.astype(np.int8))


def test_config_yaml_roundtrip(tmp_path):
    cfg = MacauConfig(num_latent=16, burnin=7, clamp=(1.0, 5.0),
                      gram_dtype="bfloat16", bucket_widths=(8, 64))
    p = str(tmp_path / "cfg.yaml")
    cfg.to_yaml(p)
    cfg2 = MacauConfig.from_yaml(p)
    assert cfg2 == cfg


def test_relation_without_test_split():
    """macau() on a relation with no test carve-out: trains fine, result
    has state/history but no RMSE key."""
    rng = np.random.default_rng(14)
    df = _lowrank_matrix(rng, 20, 15, 3)
    rd = bdf.RelationData.from_indexed_df(df)
    res = bdf.macau(rd, num_latent=3, burnin=3, psamples=3, verbose=False,
                    dtype="float32")
    assert "state" in res and "history" in res
    assert "RMSE" not in res


def test_metrics_every_batches_fetches():
    rng = np.random.default_rng(15)
    df = _lowrank_matrix(rng, 20, 15, 3)
    rd = bdf.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 20)
    cfg = MacauConfig(num_latent=3, burnin=3, psamples=3, verbose=False,
                      dtype="float32", metrics_every=3)
    res = MacauEngine(rd, cfg).run()
    fetched = [h for h in res["history"] if "r0.rmse_avg" in h]
    skipped = [h for h in res["history"] if "r0.rmse_avg" not in h]
    assert len(fetched) >= 2 and len(skipped) >= 2
    assert np.isfinite(res["RMSE"])


def test_config_kwargs_reach_engine():
    """macau(alpha=, alpha_sample=, lambda_beta=) must take effect — the
    model-level defaults are None and fall back to config (ADVICE r1)."""
    from bayesiandatafusion_jl_tpu.models.engine import CompiledProblem
    rng = np.random.default_rng(16)
    feat = (rng.random((30, 6)) < 0.3).astype(np.float64)
    df = _lowrank_matrix(rng, 30, 20, 3)
    rd = bdf.RelationData.from_matrix(df, feat1=feat)
    cfg = MacauConfig(num_latent=3, alpha=2.0, alpha_sample=True,
                      lambda_beta=10.0)
    p = CompiledProblem(rd, cfg)
    assert p.init_alpha == [2.0]
    assert p.rel_specs[0].alpha_sample
    assert p.init_lambda_beta[0] == 10.0
    assert "r0.alpha_g" in p.random_spec
    # explicit set_precision overrides the config fallback
    rd2 = bdf.RelationData.from_matrix(df)
    rd2.set_precision(0, 7.0, sample=False)
    p2 = CompiledProblem(rd2, cfg)
    assert p2.init_alpha == [7.0] and not p2.rel_specs[0].alpha_sample


def test_nnz_one_relation_smoke():
    """Degenerate single-observation relation must not crash or NaN."""
    df = bdf.IndexedDF(np.array([[0, 0]]), np.array([1.5]), (3, 2))
    rd = bdf.RelationData.from_indexed_df(df)
    res = bdf.macau(rd, num_latent=2, burnin=2, psamples=2, verbose=False,
                    dtype="float32")
    U = np.asarray(res["state"]["ent"][0]["U"])
    assert np.isfinite(U).all()


def test_sweeps_per_dispatch_bit_identical(tmp_path):
    """Scan-batched multi-sweep dispatch (config.sweeps_per_dispatch > 1)
    must produce bit-identical factors/history to the per-sweep path, and
    chunks must break at checkpoint boundaries."""
    rng = np.random.default_rng(21)
    df = _lowrank_matrix(rng, 40, 30, 3)
    rd = bdf.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 60)

    def run(spd, ckpt=None):
        cfg = MacauConfig(num_latent=3, burnin=5, psamples=6, verbose=False,
                          dtype="float32", seed=11, metrics_every=4,
                          sweeps_per_dispatch=spd,
                          checkpoint_every=3 if ckpt else 0,
                          checkpoint_path=ckpt)
        return MacauEngine(rd, cfg).run()

    base = run(1)
    for spd in (4, 11):
        res = run(spd)
        a = np.asarray(jax.device_get(base["state"]["ent"][0]["U"]))
        b = np.asarray(jax.device_get(res["state"]["ent"][0]["U"]))
        assert np.array_equal(a, b), f"spd={spd} diverged"
        assert len(res["history"]) == len(base["history"])
        assert ([("r0.rmse_avg" in h) for h in res["history"]]
                == [("r0.rmse_avg" in h) for h in base["history"]])
    # checkpoints still land on their sweeps when chunked
    ck = str(tmp_path / "ck.npz")
    res = run(8, ckpt=ck)
    a = np.asarray(jax.device_get(base["state"]["ent"][0]["U"]))
    b = np.asarray(jax.device_get(res["state"]["ent"][0]["U"]))
    assert np.array_equal(a, b)
    import os
    assert os.path.exists(ck)
