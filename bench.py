"""Benchmarks for the BASELINE.json configs, one config per process and
one JSON line on stdout each.  Runs on a GPU only.

Default config: ML-10M rank 32 rows/s/chip — the north-star metric.
Select others with BENCH_CONFIG= ml100k | chembl | tensor | tensor_big |
fusion | netflix | netflix_cont | netflix_dup | netflix_gather |
netflix_sharded1 | sharded1; BENCH_SMOKE=1 shrinks the ML and netflix
configs; BENCH_REPEATS sets the number of timed windows (default 3).
The device, the dense/fused/gather plan of every relation mode, and the
peak device memory go to stderr as "# ..." lines.

``vs_baseline`` is computed against the literature-anchored estimate of
the reference's per-core throughput: 1e5 rows/s (upper end of the
O(1e4-1e5) range for a Julia per-row K=32 sampler; SURVEY §8 — re-derive
when a Julia runtime is available).  The reference repo publishes no
benchmark numbers (BASELINE.json "published": {}).
"""
import json
import os
import sys
import time

import numpy as np

JULIA_ROWS_PER_S_ANCHOR = 1e5  # SURVEY §8 literature anchor, per core

# 25-step width ladder: padding 1.22 -> 1.13 on ML-10M (r2 notes)
WIDTHS = (8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128,
          160, 192, 224, 256, 320, 384, 512, 768, 1024, 2048)


def device_banner() -> str:
    """`kind (count) | nvidia-smi name, power limit` of the visible
    accelerator; raises SystemExit when JAX finds no GPU."""
    import subprocess

    import jax
    d = jax.devices()
    if d[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {d[0].platform!r} devices")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = [f"nvidia-smi unavailable: {e}"]
    return f"{d[0].device_kind} x{len(d)} | {smi[0] if smi else '?'}"


def plan_summary(problem) -> str:
    """'r0m0=pair r0m1=fused r1m2=gather ...' for every relation mode,
    plus 'e0.X=dense' for entities whose beta matvec streams a dense X."""
    parts = []
    for ri, rs in enumerate(problem.rel_specs):
        for mode in range(rs.arity):
            pl = problem.dense_plans.get((ri, mode))
            kind = ("gather" if pl is None
                    else "fused" if pl.kind == "fused" else "pair")
            if ri in getattr(problem, "fused_keep", {}):
                kind += "+resid"
            parts.append(f"r{ri}m{mode}={kind}")
    feat = getattr(problem, "arrays", {}).get("feat", {})
    for ek, fa in feat.items():
        if "dense_X" in fa:
            parts.append(f"{ek}.X=dense")
    return " ".join(parts)


def _time_engine(eng, sweeps, label):
    """Time `sweeps`-sweep windows through the PUBLIC engine.benchmark API.

    Runs BENCH_REPEATS timed windows (default 3) after an untimed
    compile+warm window and keeps the MEDIAN — the per-window spread is
    surfaced in the emitted JSON so a docs-vs-artifact discrepancy is
    diagnosable from the artifact alone (VERDICT r2 weak #1/#7).
    Returns (median dt/sweep seconds, metrics dict).
    """
    import jax
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    print(f"# {label}: plan {plan_summary(eng.problem)}", file=sys.stderr)
    t0 = time.time()
    out = eng.benchmark(sweeps, repeats=repeats)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"# {label}: warm window ({sweeps} sweeps, compile+run) + "
          f"{repeats} timed windows in {time.time()-t0:.1f}s; ms/sweep="
          f"{out['ms_per_sweep']}; peak_bytes_in_use="
          f"{stats.get('peak_bytes_in_use')}", file=sys.stderr)
    wins = sorted(out["ms_per_sweep"])
    med_ms = wins[len(wins) // 2]
    m = dict(out["metrics"])
    if out.get("rmse_at_sweeps") is not None:
        m["rmse_at_sweeps"] = out["rmse_at_sweeps"]
    m["_windows_ms"] = out["ms_per_sweep"]
    return med_ms / 1e3, m


def _emit(metric, value, unit="rows/s", dt=None, m=None, flops=None):
    rec = {
        "metric": metric,
        "value": round(value, 1),
        "unit": unit,
        "vs_baseline": round(value / JULIA_ROWS_PER_S_ANCHOR, 2),
    }
    if dt is not None:
        rec["ms_per_sweep"] = round(dt * 1e3, 3)
        rec["sweeps_per_s"] = round(1.0 / dt, 2)
    if m is not None and "_windows_ms" in m:
        w = m["_windows_ms"]
        rec["windows_ms_per_sweep"] = [round(x, 3) for x in w]
        mean = sum(w) / len(w)
        var = sum((x - mean) ** 2 for x in w) / max(len(w) - 1, 1)
        rec["window_cv"] = round(var ** 0.5 / mean, 4) if mean else 0.0
    if flops is not None and dt:
        rec["effective_tops"] = round(flops / dt / 1e12, 1)
    print(json.dumps(rec))


def _ml_problem(variant, sweeps):
    """(rd, cfg, df, real-data path or None) of the ML configs."""
    import bayesiandatafusion_jl_tpu as bdf
    from bayesiandatafusion_jl_tpu.models.data import IndexedDF
    from bayesiandatafusion_jl_tpu.models.datasets import load_movielens
    from bayesiandatafusion_jl_tpu.utils.config import MacauConfig

    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".cache", f"ml{variant}.npz")
    path = os.environ.get("BENCH_DATA")  # real ratings file, if provided
    if not path:
        # auto-discover a dropped-in real ratings file (VERDICT r3 #5:
        # zero builder turnaround the day the data request is met)
        from bayesiandatafusion_jl_tpu.models.datasets import \
            find_real_ratings
        path = find_real_ratings()
        if path:
            print(f"# REAL ratings file detected: {path}", file=sys.stderr)
    if path:
        df = load_movielens(variant, path=path)
    elif os.path.exists(cache):
        z = np.load(cache)
        df = IndexedDF(z["idx"], z["vals"], tuple(z["shape"]))
    else:
        df = load_movielens(variant)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, idx=df.idx, vals=df.vals, shape=df.shape)
    rd = bdf.RelationData.from_indexed_df(df, relation_name="ratings")
    rd.assign_to_test(0, min(100_000, df.nnz // 10), seed=7)
    cfg = MacauConfig(num_latent=32, burnin=sweeps, psamples=0,
                      clamp=(1.0, 5.0), verbose=False, dtype="float32",
                      gram_dtype="bfloat16", seed=42, bucket_widths=WIDTHS,
                      sweeps_per_dispatch=sweeps, dense_int8=True)
    return rd, cfg, df, path


def _ml_engine(variant, sweeps, sharded=False):
    import jax

    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    rd, cfg, df, path = _ml_problem(variant, sweeps)
    if sharded:
        from bayesiandatafusion_jl_tpu.parallel.mesh import data_mesh
        from bayesiandatafusion_jl_tpu.parallel.sharded import (
            ShardedMacauEngine)
        # mesh=1 on purpose (one device even on a multi-GPU host): this
        # cell measures the shard_map machinery against the plain engine
        return ShardedMacauEngine(rd, cfg, mesh=data_mesh(
            jax.devices()[:1])), df, path
    return MacauEngine(rd, cfg), df, path


def bench_ml(variant, sweeps, sharded=False):
    t0 = time.time()
    eng, df, real = _ml_engine(variant, sweeps, sharded=sharded)
    print(f"# data+layout build: {time.time()-t0:.1f}s "
          f"(nnz={df.nnz}, shape={df.shape})", file=sys.stderr)
    tag = "sharded mesh=1 " if sharded else ""
    dt, m = _time_engine(eng, sweeps, f"ml{variant}{' sharded' if sharded else ''}")
    n_rows = sum(es.n for es in eng.problem.entity_specs)
    rmse = m.get("rmse_at_sweeps", m["r0.rmse_sample"])
    src = "REAL data" if real else "synthetic"
    _emit(f"{tag}rows_sampled_per_s_per_chip (ML-{variant} rank 32, {src}; "
          f"sweeps/s={1/dt:.3f}, rmse_sample@{sweeps}={rmse:.4f}, "
          f"rmse_avg={m['r0.rmse_avg']:.4f})", n_rows / dt,
          dt=dt, m=m, flops=eng.problem.flops_per_sweep())


def bench_chembl():
    from bayesiandatafusion_jl_tpu.models.datasets import synthetic_chembl
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu.utils.config import MacauConfig

    rd = synthetic_chembl(n_compounds=15_000, n_targets=346,
                          n_features=32_000, nnz=300_000, seed=3)
    rd.assign_to_test(0, 30_000, seed=7)
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".cache")
    cfg = MacauConfig(num_latent=32, burnin=20, psamples=0, verbose=False,
                      dtype="float32", gram_dtype="bfloat16",
                      use_ff=False, cg_maxiter=100, seed=42,
                      sweeps_per_dispatch=20, dual_cache_dir=cache,
                      dense_int8=True)
    eng = MacauEngine(rd, cfg)
    dt, m = _time_engine(eng, 20, "chembl")
    n_rows = sum(es.n for es in eng.problem.entity_specs)
    solver = eng.problem.entity_specs[0].solver
    extra = (f"cg_iters={m['e0.cg_iters']:.0f}" if "e0.cg_iters" in m
             else f"solver={solver}")
    auc = f", auc={m['r0.auc']:.4f}" if "r0.auc" in m else ""
    _emit(f"chembl macau rows/s/chip (rmse_avg={m['r0.rmse_avg']:.4f}, "
          f"{extra}{auc})", n_rows / dt,
          dt=dt, m=m, flops=eng.problem.flops_per_sweep())


def bench_tensor():
    """Config #4: 3-way tensor relation (compound x target x context)."""
    import bayesiandatafusion_jl_tpu as bdf
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu.utils.config import MacauConfig

    rng = np.random.default_rng(5)
    n1, n2, n3, nnz, r = 30_000, 2_000, 16, 5_000_000, 32
    key = np.unique(rng.integers(0, n1 * n2 * n3, int(nnz * 1.15)))[:nnz]
    i1 = key // (n2 * n3)
    i2 = (key // n3) % n2
    i3 = key % n3
    Us = [rng.standard_normal((n, r)) / np.sqrt(r) for n in (n1, n2, n3)]
    vals = (np.sum(Us[0][i1] * Us[1][i2] * Us[2][i3], axis=1) * np.sqrt(r)
            + 0.4 * rng.standard_normal(nnz))
    df = bdf.IndexedDF(np.stack([i1, i2, i3], 1), vals, (n1, n2, n3))
    rd = bdf.RelationData.from_indexed_df(df, relation_name="tensor")
    rd.assign_to_test(0, 100_000, seed=7)
    cfg = MacauConfig(num_latent=r, burnin=15, psamples=0, verbose=False,
                      dtype="float32", gram_dtype="bfloat16", seed=42,
                      bucket_widths=WIDTHS, sweeps_per_dispatch=15,
                      dense_int8=True)
    eng = MacauEngine(rd, cfg)
    dt, m = _time_engine(eng, 15, "tensor")
    n_rows = sum(es.n for es in eng.problem.entity_specs)
    _emit(f"tensor 3-way rows/s/chip (30k x 2k x 16, 5M nnz, r32; "
          f"rmse_avg={m['r0.rmse_avg']:.4f})", n_rows / dt,
          dt=dt, m=m, flops=eng.problem.flops_per_sweep())


def bench_tensor_big():
    """Arity-3 at former-wall scale (VERDICT r3 missing #1 tail): 200k x
    20k x 8, 30M nnz, r32.  No dense path exists (the canonical tensor is
    32G cells) so all three modes ride the bucketed gather path, whose
    [rows, W, K] partner transient the row-chunked bucket_gramian
    (ops/gramian.py) bounds to its budget.  This config tracks the rate
    of the pure gather regime at scale."""
    import bayesiandatafusion_jl_tpu as bdf
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu.utils.config import MacauConfig

    rng = np.random.default_rng(8)
    n1, n2, n3, nnz, r = 200_000, 20_000, 8, 30_000_000, 32
    t0 = time.time()
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".cache", "tensor_big.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        idx, vals = z["idx"], z["vals"]
    else:
        key = np.unique(rng.integers(0, n1 * n2 * n3, int(nnz * 1.05),
                                     dtype=np.int64))[:nnz]
        i1 = (key // (n2 * n3)).astype(np.int32)
        i2 = ((key // n3) % n2).astype(np.int32)
        i3 = (key % n3).astype(np.int32)
        del key
        Us = [rng.standard_normal((n, r)).astype(np.float32) / np.sqrt(r)
              for n in (n1, n2, n3)]
        vals = (np.einsum("nk,nk,nk->n", Us[0][i1], Us[1][i2], Us[2][i3])
                * np.sqrt(r) + 0.4 * rng.standard_normal(
                    len(i1)).astype(np.float32))
        idx = np.stack([i1, i2, i3], 1)
        del Us, i1, i2, i3
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, idx=idx, vals=vals)
    df = bdf.IndexedDF(idx, vals, (n1, n2, n3))
    rd = bdf.RelationData.from_indexed_df(df, relation_name="tensor")
    rd.assign_to_test(0, 100_000, seed=7)
    print(f"# tensor_big data: {time.time()-t0:.1f}s (nnz={df.nnz})",
          file=sys.stderr)
    sweeps = 8
    t0 = time.time()
    cfg = MacauConfig(num_latent=r, burnin=sweeps, psamples=0,
                      verbose=False, dtype="float32",
                      gram_dtype="bfloat16", seed=42, bucket_widths=WIDTHS,
                      sweeps_per_dispatch=sweeps, dense_int8=True)
    eng = MacauEngine(rd, cfg)
    assert not eng.problem.dense_plans, "expected the pure gather path"
    print(f"# tensor_big layout build: {time.time()-t0:.1f}s",
          file=sys.stderr)
    dt, m = _time_engine(eng, sweeps, "tensor_big")
    n_rows = sum(es.n for es in eng.problem.entity_specs)
    rmse = m.get("rmse_at_sweeps", m["r0.rmse_sample"])
    _emit(f"tensor_big 3-way rows/s/chip (200k x 20k x 8, 30M nnz, r32, "
          f"chunked gather; rmse_sample@{sweeps}={rmse:.4f})", n_rows / dt,
          dt=dt, m=m, flops=eng.problem.flops_per_sweep())


def bench_fusion():
    """Config #5: 3-relation fusion graph over a shared compound entity."""
    import bayesiandatafusion_jl_tpu as bdf
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu.utils.config import MacauConfig

    rng = np.random.default_rng(6)
    nc, nt, na, np_, r = 50_000, 500, 3_000, 800, 32
    compound = bdf.Entity("compound", count=nc)
    target = bdf.Entity("target", count=nt)
    assay = bdf.Entity("assay", count=na)
    pathway = bdf.Entity("pathway", count=np_)
    rd = bdf.RelationData()
    Uc = rng.standard_normal((nc, r)) / np.sqrt(r)

    def rel(name, e2, n2, nnz):
        key = np.unique(rng.integers(0, nc * n2, int(nnz * 1.15)))[:nnz]
        i1, i2 = key // n2, key % n2
        V = rng.standard_normal((n2, r)) / np.sqrt(r)
        vals = (np.sum(Uc[i1] * V[i2], axis=1) * np.sqrt(r)
                + 0.4 * rng.standard_normal(nnz))
        rd.add_relation(bdf.IndexedDF(np.stack([i1, i2], 1), vals,
                                      (nc, n2)), name, [compound, e2])

    rel("ic50", target, nt, 5_000_000)
    rel("assay", assay, na, 4_000_000)
    rel("pathway", pathway, np_, 1_000_000)
    rd.assign_to_test("ic50", 100_000, seed=7)
    cfg = MacauConfig(num_latent=r, burnin=15, psamples=0, verbose=False,
                      dtype="float32", gram_dtype="bfloat16", seed=42,
                      bucket_widths=WIDTHS, sweeps_per_dispatch=15,
                      dense_int8=True)
    eng = MacauEngine(rd, cfg)
    dt, m = _time_engine(eng, 15, "fusion")
    n_rows = sum(es.n for es in eng.problem.entity_specs)
    _emit(f"fusion 3-relation rows/s/chip (50k compounds, 10M nnz, r32; "
          f"rmse_avg={m['r0.rmse_avg']:.4f})", n_rows / dt,
          dt=dt, m=m, flops=eng.problem.flops_per_sweep())


def _netflix_data(smoke=False, cont=False, dup=False):
    """The netflix configs' ratings (cached under .cache/): returns
    (df, (n1, n2), r)."""
    import bayesiandatafusion_jl_tpu as bdf

    n1, n2, r = (480_189, 17_770, 32) if not smoke else (4_800, 1_700, 32)
    nnz = 100_480_507 if not smoke else 1_000_000
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".cache", f"netflix{'_smoke' if smoke else ''}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        df = bdf.IndexedDF(z["idx"], z["vals"], (n1, n2))
    else:
        rng = np.random.default_rng(9)
        key = np.unique(rng.integers(0, n1 * n2, int(nnz * 1.02),
                                     dtype=np.int64))
        key = rng.permutation(key)[:nnz] if key.size > nnz else key
        nnz = key.size
        i1 = (key // n2).astype(np.int32)
        i2 = (key % n2).astype(np.int32)
        del key
        U = rng.standard_normal((n1, r), dtype=np.float32) / np.sqrt(r)
        V = rng.standard_normal((n2, r), dtype=np.float32) / np.sqrt(r)
        score = np.einsum("nk,nk->n", U[i1], V[i2])
        del U, V
        score = score * np.sqrt(r) * 0.9 + 0.55 * rng.standard_normal(
            nnz, dtype=np.float32)
        vals = np.clip(np.rint(3.6 + 1.1 * score), 1.0,
                       5.0).astype(np.float32)
        del score
        df = bdf.IndexedDF(np.stack([i1, i2], 1), vals, (n1, n2))
        del i1, i2, vals
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, idx=df.idx, vals=df.vals)
    if dup:
        # netflix_dup (VERDICT r4 missing #2): force a NONZERO hybrid
        # residual at full scale — every 67th observation is duplicated
        # (~1.5M extra observations), so the planner's first-per-cell
        # keep mask routes the duplicates onto the exact-valued gather
        # residual next to the 8.6 GB V8; this config measures the
        # hybrid regime at full scale.
        dsel = np.arange(0, df.nnz, 67)
        df = bdf.IndexedDF(
            np.concatenate([df.idx, df.idx[dsel]]),
            np.concatenate([df.vals, df.vals[dsel]]), df.shape)
        print(f"# netflix_dup: +{len(dsel)} duplicate observations "
              f"(total nnz={df.nnz})", file=sys.stderr)
    if cont:
        # netflix_cont (VERDICT r3 #2): the CONTINUOUS-valued variant of
        # the same shape — no exact grid exists, so the fused path
        # engages only through the dense_fused_tol bounded-error
        # contract (max value rounding error <= 0.0125 on the ~1..5
        # scale; at this tol the planner's coarser-grid search finds an
        # UNUSED shift level in the jitter gaps -> zero residual, so the
        # config isolates the tol contract at full scale; netflix_dup
        # covers the hybrid residual).  Deterministic jitter of the
        # cached integer ratings: same sparsity, values off-grid.
        rngc = np.random.default_rng(17)
        vals_c = (df.vals.astype(np.float32)
                  + rngc.uniform(-0.45, 0.45,
                                 df.nnz).astype(np.float32))
        df = bdf.IndexedDF(df.idx, vals_c, df.shape)
        del vals_c
    return df, (n1, n2), r


def _netflix_config(r, sweeps, smoke=False, cont=False, gather=False):
    from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
    return MacauConfig(
        num_latent=r, burnin=sweeps, psamples=0,
        clamp=(1.0, 5.0), verbose=False, dtype="float32",
        gram_dtype="bfloat16", seed=42, bucket_widths=WIDTHS,
        sweeps_per_dispatch=sweeps, dense_int8=True,
        dense_fused_tol=0.0125 if cont else None,
        # these configs measure the fused path and netflix_gather its
        # gather baseline, so both are forced: the auto planner prefers
        # the gather path at this shape on an H100 (ops/dense_gram.py
        # constants), and at smoke scale the int8 pair would fit
        dense_fused=None if gather else True,
        dense_gram=False if gather else None)


def build_problem(name):
    """(rd, cfg) of the ml10m or netflix config, for callers that build
    their own engines (chip_smoke.py --four-cards)."""
    import bayesiandatafusion_jl_tpu as bdf
    if name == "ml10m":
        rd, cfg, _, _ = _ml_problem("10m", 40)
        return rd, cfg
    if name == "netflix":
        df, _, r = _netflix_data()
        rd = bdf.RelationData.from_indexed_df(df, relation_name="ratings")
        rd.assign_to_test(0, 100_000, seed=7)
        return rd, _netflix_config(r, 8)
    raise ValueError(name)


def bench_netflix(gather=False, smoke=False, cont=False, sharded=False,
                  dup=False):
    """Config #6 (VERDICT r2 #1): the dense-pair-INELIGIBLE sparse regime.

    Netflix-prize-shaped: 480,189 users x 17,770 movies, 100,480,507
    observed integer ratings 1..5, rank 32.  The int8 M/W pair would be
    17.1 GB (> the 9 GB dense budget); these configs run the single-array
    fused path (8.5 GB, mask derived on the fly), and ``gather=True``
    runs the bucketed gather path instead, as its baseline."""
    import bayesiandatafusion_jl_tpu as bdf
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine

    t0 = time.time()
    df, (n1, n2), r = _netflix_data(smoke=smoke, cont=cont, dup=dup)
    rd = bdf.RelationData.from_indexed_df(df, relation_name="ratings")
    rd.assign_to_test(0, 100_000, seed=7)
    print(f"# netflix data gen: {time.time()-t0:.1f}s (nnz={df.nnz})",
          file=sys.stderr)
    sweeps = 8
    mk_cfg = lambda: _netflix_config(  # noqa: E731
        r, sweeps, smoke=smoke, cont=cont, gather=gather)
    if gather:
        # Measured at two nnz subsamples and extrapolated linearly in nnz
        # (dt = a + b*nnz) — the per-observation gather cost is flat in
        # everything else.  Raw points go into the JSON so the fit is
        # auditable.
        pts = []
        nnz_full = df.nnz
        subs = ((15_000_000, 30_000_000) if not smoke
                else (nnz_full // 4, nnz_full // 2))
        for sub in subs:
            rngs = np.random.default_rng(11)
            rows = np.sort(rngs.choice(df.nnz, size=sub, replace=False))
            df_s = bdf.IndexedDF(df.idx[rows], df.vals[rows], df.shape)
            rd_s = bdf.RelationData.from_indexed_df(
                df_s, relation_name="ratings")
            rd_s.assign_to_test(0, 100_000, seed=7)
            t0 = time.time()
            eng = MacauEngine(rd_s, mk_cfg())
            assert not eng.problem.dense_plans
            print(f"# netflix gather build ({sub/1e6:.0f}M nnz): "
                  f"{time.time()-t0:.1f}s", file=sys.stderr)
            dt, m = _time_engine(eng, sweeps, f"netflix-gather-{sub}")
            pts.append((sub, dt))
            del eng
        (n_a, dt_a), (n_b, dt_b) = pts
        b_fit = (dt_b - dt_a) / (n_b - n_a)
        dt = max(dt_a + b_fit * (nnz_full - n_a), dt_b)
        n_rows = n1 + n2
        rec_extra = {"measured_points_nnz_s": [[n_a, round(dt_a, 4)],
                                               [n_b, round(dt_b, 4)]]}
        print(f"# gather fit: dt = {dt_a - b_fit * n_a:.4f} + "
              f"{b_fit * 1e9:.3f} ns/nnz -> {dt:.3f} s/sweep at "
              f"{nnz_full/1e6:.1f}M", file=sys.stderr)
        rec = {
            "metric": ("netflix-shaped rows/s/chip (gather baseline; "
                       "EXTRAPOLATED linear-in-nnz from measured "
                       f"{n_a/1e6:.0f}M/{n_b/1e6:.0f}M subsamples)"),
            "value": round(n_rows / dt, 1),
            "unit": "rows/s",
            "vs_baseline": round(n_rows / dt / JULIA_ROWS_PER_S_ANCHOR, 2),
            "ms_per_sweep": round(dt * 1e3, 3),
            **rec_extra,
        }
        print(json.dumps(rec))
        return
    t0 = time.time()
    if sharded:
        # sparse-regime machinery-overhead proxy (like sharded1 for
        # ML-10M): the shard_map engine with the fused contraction inside
        # the mapped body, mesh=1 (one device even on a multi-GPU host)
        import dataclasses

        import jax

        from bayesiandatafusion_jl_tpu.parallel.mesh import data_mesh
        from bayesiandatafusion_jl_tpu.parallel.sharded import (
            ShardedMacauEngine)
        cfg_s = dataclasses.replace(mk_cfg(), sweeps_per_dispatch=1)
        eng = ShardedMacauEngine(rd, cfg_s,
                                 mesh=data_mesh(jax.devices()[:1]))
        assert eng.problem.fused_rels, "fused path did not engage"
        print(f"# netflix sharded build: {time.time()-t0:.1f}s",
              file=sys.stderr)
        dt, m = _time_engine(eng, sweeps, "netflix-sharded1")
        n_rows = sum(es.n for es in eng.problem.entity_specs)
        rmse = m.get("rmse_at_sweeps", m["r0.rmse_sample"])
        _emit(f"sharded mesh=1 netflix-shaped rows/s/chip (fused; "
              f"rmse_sample@{sweeps}={rmse:.4f})", n_rows / dt,
              dt=dt, m=m, flops=eng.problem.flops_per_sweep())
        return
    eng = MacauEngine(rd, mk_cfg())
    assert eng.problem.fused_rels, "fused path did not engage"
    tag = "fused"
    if cont:
        assert eng.problem.fused_i8.get(0), \
            "continuous grid fell off the s8 path (per-fiber bound)"
        tag = "fused tol=0.0125 continuous"
    if dup:
        kp = eng.problem.fused_keep.get(0)
        # test-split removal drops whole cells (duplicates included), so
        # the surviving residual is a bit under the injected count
        assert kp is not None and (~kp).sum() >= df.nnz // 150, \
            "expected a nonzero hybrid residual"
        tag = f"fused + {(~kp).sum()/1e6:.1f}M-obs gather residual"
    print(f"# netflix engine build (fused): {time.time()-t0:.1f}s",
          file=sys.stderr)
    dt, m = _time_engine(eng, sweeps,
                         "netflix-cont" if cont else "netflix-fused")
    n_rows = sum(es.n for es in eng.problem.entity_specs)
    rmse = m.get("rmse_at_sweeps", m["r0.rmse_sample"])
    _emit(f"netflix-shaped rows/s/chip ({tag}; 480k x 17.8k, 100.5M nnz, "
          f"r32; rmse_sample@{sweeps}={rmse:.4f})", n_rows / dt,
          dt=dt, m=m, flops=eng.problem.flops_per_sweep())


def main():
    from bayesiandatafusion_jl_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()
    print(f"# device: {device_banner()}", file=sys.stderr)
    cfg = os.environ.get("BENCH_CONFIG", "")
    smoke = os.environ.get("BENCH_SMOKE") == "1"
    if cfg in ("", "ml10m"):
        bench_ml("100k" if smoke else "10m", 10 if smoke else 40)
    elif cfg == "ml100k":
        # tiny config: a long chain per window, so per-window dispatch
        # and the end-of-window read are a small share of it
        bench_ml("100k", 200)
    elif cfg == "chembl":
        bench_chembl()
    elif cfg == "tensor":
        bench_tensor()
    elif cfg == "tensor_big":
        bench_tensor_big()
    elif cfg == "fusion":
        bench_fusion()
    elif cfg == "netflix":
        bench_netflix(smoke=smoke)
    elif cfg == "netflix_cont":
        bench_netflix(cont=True, smoke=smoke)
    elif cfg == "netflix_dup":
        bench_netflix(dup=True, smoke=smoke)
    elif cfg == "netflix_gather":
        bench_netflix(gather=True, smoke=smoke)
    elif cfg == "netflix_sharded1":
        bench_netflix(sharded=True, smoke=smoke)
    elif cfg == "sharded1":
        bench_ml("100k" if smoke else "10m", 10 if smoke else 40,
                 sharded=True)
    else:
        raise SystemExit(f"unknown BENCH_CONFIG={cfg!r}")


if __name__ == "__main__":
    main()
