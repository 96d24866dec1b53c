"""chip_smoke.py on the CPU: it must refuse to report without a GPU, and
its phases' functions must hold at toy size (the card runs them at
ML-10M width)."""
import os
import subprocess
import sys

import numpy as np

import bayesiandatafusion_jl_tpu as bdf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ratings_rd(seed=0, n1=60, n2=45, density=0.4):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n1, 3))
    V = rng.standard_normal((n2, 3))
    mask = rng.random((n1, n2)) < density
    idx = np.stack(np.nonzero(mask), 1)
    vals = np.clip(np.round(3.0 + np.sum(U[idx[:, 0]] * V[idx[:, 1]], 1)),
                   1.0, 5.0)
    rd = bdf.RelationData.from_indexed_df(bdf.IndexedDF(idx, vals, (n1, n2)))
    rd.assign_to_test(0, 100, seed=1)
    return rd


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]
    assert "no GPU" in r.stderr


def test_reference_phase_toy_size():
    """f32 gather and dense sweeps vs the f64 oracle, same randoms."""
    import chip_smoke as cs
    report, engines = cs.reference_phase(_ratings_rd(), num_latent=4)
    for path in ("gather", "dense"):
        for prec in ("highest", "default"):
            errs = report[path][prec]
            assert errs["U"] <= cs.REF_TOL_U, (path, prec, errs)
            assert max(errs["mu"], errs["Lambda"]) <= cs.REF_TOL_HYPER
    assert set(engines) == {"gather", "dense"}


def test_int8_check_and_plan_mirror_toy_size():
    """The int8-vs-f32 contraction check holds at toy size, and the
    probe phase's plan resolver agrees with the engine's own plan."""
    import bench
    import chip_smoke as cs
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    rd = _ratings_rd(seed=3)
    e32 = MacauEngine(rd, cs.engine_config(num_latent=4, dense_gram=True))
    e8 = MacauEngine(rd, cs.engine_config(num_latent=4, dense_gram=True,
                                          dense_int8=True,
                                          gram_dtype="bfloat16"))
    errs = cs.int8_contraction_check(e32, e8)
    assert set(errs) == {0, 1}
    spec = {"rels": [(tuple(e.count for e in rd.entities),
                      rd.relations[0].data.nnz, True)], "dense_gram": True}
    old_k = cs.K
    try:
        cs.K = 4
        assert cs.resolve_plan(spec) == bench.plan_summary(e8.problem)
    finally:
        cs.K = old_k
