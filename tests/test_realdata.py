"""Real-data north-star gate (VERDICT r3 #5, pre-wired).

Skipped until a real MovieLens-family ratings file lands under
``.cache/`` (the standing BASELINE.md data request: ``ratings.dat`` /
``u.data`` / ``ratings.csv``, top level or one directory down).  The day
it lands this file un-skips with zero builder turnaround and checks the
held-out RMSE trajectory against the literature anchors:

- ML-100k  (nnz ~1e5): converged BPMF ~0.90; @40 sweeps ~0.92-0.97
- ML-1M    (nnz ~1e6): converged ~0.86-0.87
- ML-10M   (nnz ~1e7): converged ~0.86 (BASELINE.md anchor); the CPU
  test subsamples to 2M observations (higher RMSE), so it asserts a
  broad sanity band — the precise full-scale sweep-for-sweep check is
  bench.py's job on the GPU (it auto-detects the same file and tags the
  JSON metric "REAL data").

The bands are deliberately wide: they catch gross model wrongness (an
unlearning chain sits at the ratings stdev, ~1.05-1.12), not MCMC noise.
"""
import numpy as np
import pytest

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.datasets import (_parse_movielens_file,
                                                       find_real_ratings)

_REAL = find_real_ratings()

pytestmark = pytest.mark.skipif(
    _REAL is None,
    reason="no real ratings file under .cache/ (BASELINE.md data request)")


@pytest.mark.slow
def test_real_movielens_rmse_trajectory():
    df = _parse_movielens_file(_REAL)
    nnz = df.nnz
    rng = np.random.default_rng(13)
    if nnz > 2_000_000:
        rows = np.sort(rng.choice(nnz, 2_000_000, replace=False))
        df = bdf.IndexedDF(df.idx[rows], df.vals[rows], df.shape)
    rd = bdf.RelationData.from_indexed_df(df, relation_name="ratings")
    rd.assign_to_test(0, min(100_000, df.nnz // 10), seed=7)
    res = bdf.macau(rd, num_latent=16, burnin=20, psamples=20,
                    clamp=(1.0, 5.0), verbose=False, dtype="float32",
                    seed=42, sweeps_per_dispatch=10)
    rmse = float(res["RMSE"])
    # band by dataset size (posterior-average RMSE after 40 sweeps)
    if nnz < 2e5:
        lo, hi = 0.82, 1.02      # ML-100k
    elif nnz < 2e6:
        lo, hi = 0.78, 0.95      # ML-1M
    else:
        lo, hi = 0.78, 1.02      # ML-10M (subsampled -> higher than 0.86)
    assert lo < rmse < hi, (
        f"real-data RMSE {rmse:.4f} outside the literature-anchored band "
        f"({lo}, {hi}) for nnz={nnz}")
