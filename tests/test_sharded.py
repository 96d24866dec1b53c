"""Multi-device tests on a virtual 8-device CPU mesh (SURVEY.md §6
implication (b) and §7.2: same seed => same factors across shardings, up
to reduction-order float error)."""
import jax
import jax.numpy as jnp
import numpy as np
import dataclasses
import pytest

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
from bayesiandatafusion_jl_tpu.parallel.mesh import data_mesh
from bayesiandatafusion_jl_tpu.parallel.sharded import ShardedMacauEngine
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig


pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")


def _lowrank(rng, n1, n2, k=3, density=0.5, noise=0.1):
    U = rng.standard_normal((n1, k))
    V = rng.standard_normal((n2, k))
    R = U @ V.T + noise * rng.standard_normal((n1, n2))
    mask = rng.random((n1, n2)) < density
    return bdf.IndexedDF(np.stack(np.nonzero(mask), 1), R[mask], (n1, n2))


def _compare_engines(rd_builder, cfg, n_sweeps=3, rtol=1e-8):
    """Run single-device vs 8-device sharded with the same seed; factors in
    original order must agree to float tolerance."""
    rd1 = rd_builder()
    eng1 = MacauEngine(rd1, cfg)
    r1 = eng1.run(num_sweeps=n_sweeps)

    rd2 = rd_builder()
    eng8 = ShardedMacauEngine(rd2, cfg, mesh=data_mesh())
    r8 = eng8.run(num_sweeps=n_sweeps)

    U8 = eng8.factors_original_order(r8["state"][0])
    for ei in range(len(rd1.entities)):
        U1 = np.asarray(r1["state"]["ent"][ei]["U"])
        np.testing.assert_allclose(U8[ei], U1, rtol=rtol, atol=rtol,
                                   err_msg=f"entity {ei} factors diverged")
    return r1, r8


def test_sharded_matches_single_bpmf():
    rng = np.random.default_rng(0)
    df = _lowrank(rng, 53, 37)  # sizes not divisible by 8: padding exercised
    def build():
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 70, seed=1)
        return rd
    cfg = MacauConfig(num_latent=3, burnin=2, psamples=2, verbose=False,
                      dtype="float64", seed=5)
    r1, r8 = _compare_engines(build, cfg, n_sweeps=4)
    # prediction accumulators agree too
    np.testing.assert_allclose(r8["predictions"]["pred"],
                               r1["predictions"]["pred"],
                               rtol=1e-8, atol=1e-8)


def test_sharded_matches_single_macau_ff():
    rng = np.random.default_rng(1)
    feat = (rng.random((53, 17)) < 0.25).astype(np.float64)
    df = _lowrank(rng, 53, 37)
    def build():
        rd = bdf.RelationData.from_matrix(df, feat1=feat)
        rd.assign_to_test(0, 50, seed=2)
        return rd
    cfg = MacauConfig(num_latent=3, burnin=1, psamples=2, verbose=False,
                      dtype="float64", use_ff=True, seed=6)
    _compare_engines(build, cfg, n_sweeps=3)


def test_sharded_matches_single_macau_cg():
    rng = np.random.default_rng(2)
    feat = (rng.random((41, 23)) < 0.25).astype(np.float64)
    df = _lowrank(rng, 41, 29)
    def build():
        rd = bdf.RelationData.from_matrix(df, feat1=feat)
        rd.assign_to_test(0, 40, seed=3)
        return rd
    cfg = MacauConfig(num_latent=3, burnin=1, psamples=2, verbose=False,
                      dtype="float64", use_ff=False, cg_tol=1e-12, seed=7)
    _compare_engines(build, cfg, n_sweeps=3, rtol=1e-6)


def test_sharded_matches_single_macau_cg_realvalued():
    """Real-valued side info: sharded weighted matvec + psum CG must match
    the single-device engine."""
    rng = np.random.default_rng(17)
    feat = rng.standard_normal((41, 23)) * (rng.random((41, 23)) < 0.3)
    df = _lowrank(rng, 41, 29)
    def build():
        rd = bdf.RelationData.from_matrix(df, feat1=feat)
        rd.assign_to_test(0, 40, seed=3)
        return rd
    assert not build().entities[0].F.is_binary
    cfg = MacauConfig(num_latent=3, burnin=1, psamples=2, verbose=False,
                      dtype="float64", use_ff=False, cg_tol=1e-12, seed=7)
    _compare_engines(build, cfg, n_sweeps=3, rtol=1e-6)


def test_sharded_matches_single_macau_cg_nystrom():
    """Nystrom-preconditioned CG: the replicated preconditioner must leave
    sharded == single-device parity intact (same seed => same U, d)."""
    rng = np.random.default_rng(23)
    feat = (rng.random((41, 23)) < 0.25).astype(np.float64)
    df = _lowrank(rng, 41, 29)
    def build():
        rd = bdf.RelationData.from_matrix(df, feat1=feat)
        rd.assign_to_test(0, 40, seed=3)
        return rd
    cfg = MacauConfig(num_latent=3, burnin=1, psamples=2, verbose=False,
                      dtype="float64", use_ff=False, cg_tol=1e-12,
                      cg_nystrom_rank=4, seed=7)
    eng = ShardedMacauEngine(build(), cfg, mesh=data_mesh())
    assert "e0" in eng.problem.arrays_rep["nys"]
    _compare_engines(build, cfg, n_sweeps=3, rtol=1e-6)


def test_sharded_matches_single_tensor_multirel_alpha():
    rng = np.random.default_rng(3)
    shape = (19, 13, 5)
    T = rng.standard_normal(shape)
    mask = rng.random(shape) < 0.4
    df3 = bdf.IndexedDF(np.stack(np.nonzero(mask), 1), T[mask], shape)
    m2 = rng.random((19, 11)) < 0.5
    R2 = rng.standard_normal((19, 11))
    df2 = bdf.IndexedDF(np.stack(np.nonzero(m2), 1), R2[m2], (19, 11))

    def build():
        e1 = bdf.Entity("e1", count=19)
        e2 = bdf.Entity("e2", count=13)
        e3 = bdf.Entity("e3", count=5)
        e4 = bdf.Entity("e4", count=11)
        rd = bdf.RelationData()
        rd.add_relation(df3, "tensor", [e1, e2, e3])
        rd.add_relation(df2, "aux", [e1, e4])
        rd.assign_to_test("tensor", 30, seed=4)
        rd.set_precision("aux", 2.0, sample=True)
        return rd

    cfg = MacauConfig(num_latent=2, burnin=1, psamples=2, verbose=False,
                      dtype="float64", seed=8)
    _compare_engines(build, cfg, n_sweeps=3)


def test_block_pipelined_exchange_matches():
    """exchange_blocks > 1 must not change results (row blocks of one
    entity are conditionally independent; SURVEY §7.7)."""
    rng = np.random.default_rng(9)
    df = _lowrank(rng, 64, 48)
    def build():
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 60, seed=1)
        return rd
    cfg1 = MacauConfig(num_latent=3, burnin=1, psamples=2, verbose=False,
                       dtype="float64", seed=5, exchange_blocks=1)
    cfg4 = MacauConfig(num_latent=3, burnin=1, psamples=2, verbose=False,
                       dtype="float64", seed=5, exchange_blocks=4)
    e1 = ShardedMacauEngine(build(), cfg1, mesh=data_mesh())
    r1 = e1.run(num_sweeps=3)
    e4 = ShardedMacauEngine(build(), cfg4, mesh=data_mesh())
    r4 = e4.run(num_sweeps=3)
    U1 = e1.factors_original_order(r1["state"][0])
    U4 = e4.factors_original_order(r4["state"][0])
    for a, b in zip(U1, U4):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


def test_sharded_checkpoint_resume_exact(tmp_path):
    rng = np.random.default_rng(11)
    df = _lowrank(rng, 40, 24)
    rd = bdf.RelationData.from_indexed_df(df)
    rd.assign_to_test(0, 40, seed=2)
    cfg = MacauConfig(num_latent=3, burnin=3, psamples=3, verbose=False,
                      dtype="float32", seed=21)
    eng = ShardedMacauEngine(rd, cfg, mesh=data_mesh())
    key = jax.random.key(cfg.seed)
    full = eng.run(state=eng.init_state(jax.random.fold_in(key, 0)), key=key)

    from bayesiandatafusion_jl_tpu.utils.rng import sweep_key
    st = eng.init_state(jax.random.fold_in(key, 0))
    sr, ss = st
    p = eng.problem
    for s in range(3):
        sr, ss, _ = eng._sweep_jit(p.arrays_sh, p.arrays_rep, sr, ss,
                                   sweep_key(key, s + 1), 0.0)
    path = str(tmp_path / "sck.npz")
    eng.save_state(path, (sr, ss), 3)
    st2, sw = eng.load_state(path)
    resumed = eng.run(state=st2, key=key, sweep_offset=sw)
    assert full["RMSE"] == resumed["RMSE"]


def test_sharded_run_aux_parity(tmp_path):
    """ShardedMacauEngine.run() honors the full aux surface: metrics_every
    batching, log_file, output_prefix dumps (original instance order),
    and per-sweep AUC/betanorm metrics matching the single-device engine."""
    rng = np.random.default_rng(21)
    n1, n2, k, f = 40, 24, 3, 10
    feat = (rng.random((n1, f)) < 0.4).astype(np.float64)
    df = _lowrank(rng, n1, n2, k)

    def build():
        rd = bdf.RelationData.from_matrix(df, feat1=feat, class_cut=0.0)
        rd.assign_to_test(0, 40, seed=2)
        return rd

    def cfg(**kw):
        return MacauConfig(num_latent=k, burnin=2, psamples=3,
                           verbose=False, dtype="float64", use_ff=True,
                           seed=33, **kw)

    r1 = MacauEngine(build(), cfg()).run()
    log = str(tmp_path / "sweeps.jsonl")
    prefix = str(tmp_path / "sh")
    r8 = ShardedMacauEngine(build(), cfg(log_file=log,
                                         output_prefix=prefix),
                            mesh=data_mesh()).run()
    # per-sweep metrics parity (identical RNG; f64)
    for h1, h8 in zip(r1["history"], r8["history"]):
        for key in ("r0.rmse_avg", "r0.auc", "e0.betanorm",
                    "e0.lambda_beta"):
            np.testing.assert_allclose(h8[key], h1[key], rtol=1e-8,
                                       err_msg=key)
    # jsonl log written
    import json
    lines = [json.loads(l) for l in open(log)]
    assert len(lines) == 5 and lines[-1]["sweep"] == 5
    # posterior dumps exist and factors are in ORIGINAL order
    import glob
    files = sorted(glob.glob(prefix + "-sample*.npz"))
    assert len(files) == 3
    z = np.load(files[-1])
    U8 = np.asarray(z["e0.U"])
    eng8 = ShardedMacauEngine(build(), cfg(), mesh=data_mesh())
    assert U8.shape == (n1, k)
    np.testing.assert_allclose(
        U8, np.asarray(r1["state"]["ent"][0]["U"]), rtol=1e-8, atol=1e-8)

    # metrics_every gating: no per-sweep fetch unless forced
    rME = ShardedMacauEngine(build(), cfg(metrics_every=5),
                             mesh=data_mesh()).run()
    skipped = [h for h in rME["history"] if "r0.rmse_avg" not in h]
    assert len(skipped) >= 3


def test_head_split_matches_single():
    """Head-entity splitting (psum-reduced ghost slots) must reproduce the
    unsplit result exactly (up to reduction order)."""
    rng = np.random.default_rng(13)
    n1, n2 = 40, 30
    mask = rng.random((n1, n2)) < 0.3
    mask[:, 0] = True   # head column: degree 40
    mask[5, :] = True   # head row: degree 30
    idx = np.stack(np.nonzero(mask), 1)
    df = bdf.IndexedDF(idx, rng.standard_normal(idx.shape[0]), (n1, n2))

    def build():
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 50, seed=1)
        return rd

    cfg_plain = MacauConfig(num_latent=3, burnin=1, psamples=2,
                            verbose=False, dtype="float64", seed=9)
    cfg_split = MacauConfig(num_latent=3, burnin=1, psamples=2,
                            verbose=False, dtype="float64", seed=9,
                            head_split_degree=20)
    e1 = MacauEngine(build(), cfg_plain)
    r1 = e1.run(num_sweeps=3)
    e8 = ShardedMacauEngine(build(), cfg_split, mesh=data_mesh())
    assert any(m.n_head > 0 for m in e8.problem.ent_meta), \
        "head splitting did not trigger"
    r8 = e8.run(num_sweeps=3)
    U8 = e8.factors_original_order(r8["state"][0])
    for ei in range(2):
        np.testing.assert_allclose(
            U8[ei], np.asarray(r1["state"]["ent"][ei]["U"]),
            rtol=1e-8, atol=1e-8)


def test_sharded_dense_gram_matches_single():
    """Dense-matmul path on both engines: 8-device focus-sharded M/W slabs
    must reproduce the single-device dense engine (and hence the oracle)
    at 1e-8, including a dense mode coexisting with head splitting."""
    rng = np.random.default_rng(11)
    df = _lowrank(rng, 53, 37)
    def build():
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 70, seed=1)
        return rd
    cfg = MacauConfig(num_latent=3, burnin=2, psamples=2, verbose=False,
                      dtype="float64", dense_gram=True, seed=5)
    r1, r8 = _compare_engines(build, cfg, n_sweeps=4)
    np.testing.assert_allclose(r8["predictions"]["pred"],
                               r1["predictions"]["pred"],
                               rtol=1e-8, atol=1e-8)


def test_sharded_dense_int8_matches_single():
    """int8 dense path on both engines: the exact-int32 dots and
    prefix-restricted quantization scales (pad rows excluded) keep the
    8-device run equal to the single-device int8 run at 1e-8."""
    rng = np.random.default_rng(17)
    df = _lowrank(rng, 53, 37)

    def build():
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 70, seed=1)
        return rd

    cfg = MacauConfig(num_latent=3, burnin=2, psamples=2, verbose=False,
                      dtype="float64", dense_gram=True, dense_int8=True,
                      seed=5)
    eng8 = ShardedMacauEngine(build(), cfg, mesh=data_mesh())
    assert eng8.problem.dense_w_scale, "int8 store did not engage"
    r1, r8 = _compare_engines(build, cfg, n_sweeps=4)
    np.testing.assert_allclose(r8["predictions"]["pred"],
                               r1["predictions"]["pred"],
                               rtol=1e-8, atol=1e-8)


def test_sharded_fused_matches_single():
    """Single-array fused dense path on both engines: mode 0 contracts the
    row-sharded V8 slab locally; mode 1 contracts the sharded axis and
    psum_scatters partials into each device's focus slice.  Grid-valued
    relation so the exact encoding engages; 1e-8 parity in f64."""
    rng = np.random.default_rng(23)
    n1, n2 = 53, 37
    mask = rng.random((n1, n2)) < 0.5
    idx = np.stack(np.nonzero(mask), 1)
    vals = rng.choice(np.arange(1.0, 6.0), idx.shape[0])
    df = bdf.IndexedDF(idx, vals, (n1, n2))

    def build():
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 70, seed=1)
        return rd

    cfg = MacauConfig(num_latent=3, burnin=2, psamples=2, verbose=False,
                      dtype="float64", dense_gram=True, dense_fused=True,
                      seed=5, clamp=(1.0, 5.0))
    eng8 = ShardedMacauEngine(build(), cfg, mesh=data_mesh())
    assert eng8.problem.fused_rels, "fused path did not engage (sharded)"
    r1, r8 = _compare_engines(build, cfg, n_sweeps=4)
    np.testing.assert_allclose(r8["predictions"]["pred"],
                               r1["predictions"]["pred"],
                               rtol=1e-8, atol=1e-8)


def test_sharded_fused_int8_matches_single():
    """Fused s8 variant on both engines: the partner table is
    quantized against column-max scales over the valid prefix
    (permutation-invariant), the contraction accumulates in exact int32,
    and mode 1 psums the RAW int32 partials before dequantizing — so the
    8-device factors equal the single-device int8-fused run at 1e-8."""
    rng = np.random.default_rng(41)
    n1, n2 = 53, 37
    mask = rng.random((n1, n2)) < 0.5
    idx = np.stack(np.nonzero(mask), 1)
    vals = rng.choice(np.arange(1.0, 6.0), idx.shape[0])
    df = bdf.IndexedDF(idx, vals, (n1, n2))

    def build():
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 70, seed=1)
        return rd

    cfg = MacauConfig(num_latent=3, burnin=2, psamples=2, verbose=False,
                      dtype="float64", dense_gram=True, dense_fused=True,
                      dense_int8=True, seed=9, clamp=(1.0, 5.0))
    eng8 = ShardedMacauEngine(build(), cfg, mesh=data_mesh())
    assert eng8.problem.fused_i8.get(0), "fused s8 variant did not engage"
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    assert MacauEngine(build(), cfg).problem.fused_i8.get(0)
    r1, r8 = _compare_engines(build, cfg, n_sweeps=4)
    np.testing.assert_allclose(r8["predictions"]["pred"],
                               r1["predictions"]["pred"],
                               rtol=1e-8, atol=1e-8)


def test_sharded_fused_hybrid_matches_single():
    """Hybrid fused relation (duplicate observations ride the exact
    gather residual alongside the row-sharded V8): both engines split
    identically (fused_pair_plan is layout-invariant) and the 8-device
    factors match the single-device run at 1e-8 in f64."""
    rng = np.random.default_rng(57)
    n1, n2 = 53, 37
    mask = rng.random((n1, n2)) < 0.5
    idx = np.stack(np.nonzero(mask), 1)
    vals = rng.choice(np.arange(1.0, 6.0), idx.shape[0])
    idx_d = np.concatenate([idx, idx[:11]], 0)
    vals_d = np.concatenate([vals, rng.choice(np.arange(1.0, 6.0), 11)])
    df = bdf.IndexedDF(idx_d, vals_d, (n1, n2))

    def build():
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 70, seed=1)
        return rd

    cfg = MacauConfig(num_latent=3, burnin=2, psamples=2, verbose=False,
                      dtype="float64", dense_gram=True, dense_fused=True,
                      seed=15, clamp=(1.0, 5.0))
    eng8 = ShardedMacauEngine(build(), cfg, mesh=data_mesh())
    assert eng8.problem.fused_rels, "fused path did not engage (sharded)"
    assert eng8.problem.fused_keep, "hybrid residual did not engage"
    r1, r8 = _compare_engines(build, cfg, n_sweeps=4)
    np.testing.assert_allclose(r8["predictions"]["pred"],
                               r1["predictions"]["pred"],
                               rtol=1e-8, atol=1e-8)


def test_sharded_fused_with_head_split():
    """Fused modes ignore head splitting (row-balanced matmul work); the
    ghost-slot machinery must stay structurally idle and parity hold."""
    rng = np.random.default_rng(29)
    n1, n2 = 53, 9
    mask = rng.random((n1, n2)) < 0.4
    mask[:, 0] = True                       # head partner instance
    idx = np.stack(np.nonzero(mask), 1)
    vals = rng.choice(np.arange(1.0, 6.0), idx.shape[0])
    df = bdf.IndexedDF(idx, vals, (n1, n2))

    def build():
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 30, seed=1)
        return rd

    cfg = MacauConfig(num_latent=3, burnin=1, psamples=2, verbose=False,
                      dtype="float64", dense_gram=True, dense_fused=True,
                      head_split_degree=40, seed=7)
    _compare_engines(build, cfg, n_sweeps=3)


def test_sharded_dense_gram_tensor_multirel():
    """Dense sharded slabs for a fusion graph with a 3-way tensor: every
    mode of every relation goes dense (per-mode pairs), alpha sampled."""
    rng = np.random.default_rng(12)
    nc, nt, na = 33, 21, 6
    e_c = bdf.Entity("c", count=nc)
    e_t = bdf.Entity("t", count=nt)
    e_a = bdf.Entity("a", count=na)

    shape3 = (nc, nt, na)
    T = rng.standard_normal(shape3)
    m3 = rng.random(shape3) < 0.2
    idx3 = np.stack(np.nonzero(m3), 1)
    m2 = rng.random((nc, nt)) < 0.5
    R2 = rng.standard_normal((nc, nt))
    idx2 = np.stack(np.nonzero(m2), 1)

    def build():
        rd = bdf.RelationData()
        rd.add_relation(bdf.IndexedDF(idx3, T[m3], shape3), "ternary",
                        [e_c, e_t, e_a])
        rd.add_relation(bdf.IndexedDF(idx2, R2[m2], (nc, nt)), "pair",
                        [e_c, e_t])
        rd.set_precision("pair", 2.0, sample=True)
        rd.assign_to_test("ternary", 40, seed=3)
        return rd

    cfg = MacauConfig(num_latent=2, burnin=1, psamples=2, verbose=False,
                      dtype="float64", dense_gram=True, seed=13)
    _compare_engines(build, cfg, n_sweeps=3)
    # and the int8 store (largest-partner-axis s8 dot + f32 finish):
    # parity must hold for tensor + multi-relation modes too
    cfg8 = dataclasses.replace(cfg, dense_int8=True)
    eng8 = ShardedMacauEngine(build(), cfg8, mesh=data_mesh())
    assert eng8.problem.dense_w_scale, "int8 store did not engage"
    _compare_engines(build, cfg8, n_sweeps=3)


def test_sharded_sweeps_per_dispatch_bit_identical():
    """Scan-batched dispatch on the sharded engine: bit-identical to its
    own per-sweep path."""
    rng = np.random.default_rng(31)
    df = _lowrank(rng, 48, 36)
    def build():
        rd = bdf.RelationData.from_indexed_df(df)
        rd.assign_to_test(0, 40, seed=7)
        return rd

    def run(spd):
        cfg = MacauConfig(num_latent=3, burnin=4, psamples=5, verbose=False,
                          dtype="float32", seed=13, metrics_every=3,
                          sweeps_per_dispatch=spd)
        return ShardedMacauEngine(build(), cfg, mesh=data_mesh()).run()

    r1, r6 = run(1), run(6)
    a = np.asarray(jax.device_get(r1["state"][0]["ent"][0]["U"]))
    b = np.asarray(jax.device_get(r6["state"][0]["ent"][0]["U"]))
    assert np.array_equal(a, b)


def test_sharded_matches_single_macau_dual():
    """Woodbury dual solver: row-sharded Q with psum-reduced Q't / X't2
    must match the single-device dual engine (shared eigenbasis)."""
    rng = np.random.default_rng(33)
    feat = (rng.random((41, 50)) < 0.2).astype(np.float64)   # N < F
    df = _lowrank(rng, 41, 29)
    def build():
        rd = bdf.RelationData.from_matrix(df, feat1=feat)
        rd.assign_to_test(0, 40, seed=3)
        return rd
    cfg = MacauConfig(num_latent=3, burnin=1, psamples=2, verbose=False,
                      dtype="float64", use_ff=False, beta_solver="dual",
                      seed=7)
    eng = ShardedMacauEngine(build(), cfg, mesh=data_mesh())
    assert eng.problem.entity_specs[0].solver == "dual"
    assert "dual_Q" in eng.problem.arrays_sh["feat"]["e0"]
    _compare_engines(build, cfg, n_sweeps=3, rtol=1e-8)


def test_knob_auto_resolvers():
    """Auto defaults for the SURVEY §7.7 knobs (VERDICT r2 weak #4)."""
    from bayesiandatafusion_jl_tpu.parallel.sharded import (
        resolve_exchange_blocks, resolve_head_split)
    # exchange: off at mesh=1 or small shards, 4 when overlap pays
    assert resolve_exchange_blocks(None, 1, 1 << 20) == 1
    assert resolve_exchange_blocks(None, 8, 100) == 1
    assert resolve_exchange_blocks(None, 8, 8192) == 4
    assert resolve_exchange_blocks(2, 1, 10) == 2      # explicit wins
    # head split: explicit/off passthrough
    deg = np.full(1000, 100, np.int64)
    assert resolve_head_split(None, deg, 8) is None
    assert resolve_head_split(17, deg, 8) == 17
    # auto: balanced degrees -> off
    assert resolve_head_split("auto", deg, 8) is None
    # auto: one instance dominating a device's share -> threshold set
    deg2 = deg.copy()
    deg2[0] = 40_000                    # > 0.25 * (140k/8)
    thr = resolve_head_split("auto", deg2, 8)
    assert thr is not None and deg2.max() > thr
    # mesh=1: never split
    assert resolve_head_split("auto", deg2, 1) is None
