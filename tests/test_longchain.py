"""Long-chain production-path quality gates (VERDICT r2 #3).

The headline bench path runs x32 + dense_int8; its deliberate approximations —
int8 quantization with the PD safety ridge — were validated in r2 only by
one-off forensic runs.  These tests make the validation automated: a 200-sweep
int8 chain must track the f64 gather-path RMSE trajectory within MCMC noise,
and the PD-ridge's effect on the posterior spread must stay bounded.
"""
import numpy as np
import pytest

import jax

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.datasets import synthetic_ratings
from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig


def _run_chain(dtype, dense, sweeps=200, **kw):
    df = synthetic_ratings(943, 1682, 100_000, seed=5)
    rd = bdf.RelationData.from_indexed_df(df, relation_name="ratings")
    rd.assign_to_test(0, 10_000, seed=7)
    cfg = MacauConfig(num_latent=32, burnin=sweeps // 2,
                      psamples=sweeps - sweeps // 2, clamp=(1.0, 5.0),
                      verbose=False, dtype=dtype, seed=42,
                      sweeps_per_dispatch=25,
                      metrics_every=25, **kw)
    eng = MacauEngine(rd, cfg)
    if dense == "int8":
        assert eng.problem.dense_w_scale, "int8 dense path did not engage"
    res = eng.run()
    traj = [h["r0.rmse_sample"] for h in res["history"]
            if "r0.rmse_sample" in h]
    return res, np.asarray(traj)


@pytest.mark.slow
def test_int8_chain_tracks_f64_gather_trajectory():
    """200 sweeps of the production int8 path (exact-int32 dots,
    quantized tables, PD safety ridge) vs 200 sweeps of the f64 gather
    path: the held-out RMSE trajectory and the posterior-mean RMSE must
    agree within MCMC noise.  The chains themselves diverge chaotically
    (different rounding => different sample paths) — it is the QUALITY
    statistic that must track (BASELINE 'sweep-for-sweep RMSE' gate,
    standing in for real data until the driver provides it)."""
    res8, traj8 = _run_chain("float32", "int8", gram_dtype="bfloat16",
                             dense_gram=True, dense_int8=True)
    res64, traj64 = _run_chain("float64", "gather", dense_gram=False)
    # posterior-mean RMSE: the headline quality number
    assert abs(res8["RMSE"] - res64["RMSE"]) < 0.01, (
        res8["RMSE"], res64["RMSE"])
    # per-sweep trajectory, tail window (mixed chains)
    t8, t64 = traj8[-4:].mean(), traj64[-4:].mean()
    assert abs(t8 - t64) < 0.015, (t8, t64)
    # the PD ridge is a deliberate bias: bound its effect on the
    # posterior SPREAD (sampled-prediction stdev), not just the mean
    s8 = float(res8["predictions"]["stdev"].mean())
    s64 = float(res64["predictions"]["stdev"].mean())
    assert abs(s8 - s64) / s64 < 0.10, (s8, s64)
