#!/usr/bin/env python3
"""Bring-up check of the Gibbs engine on one NVIDIA GPU.

    python chip_smoke.py                 # default phases, one GPU
    python chip_smoke.py --all-configs   # only: one warm + one timed
                                         #   window of every bench.py
                                         #   config, each in its own
                                         #   child process
    python chip_smoke.py --four-cards    # only: the sharded engine on a
                                         #   4-GPU mesh vs one GPU

Default phases, in one process on one card:

1. reference: one sweep of the engine at ML-10M width (71,567 x 10,681,
   10.0M ratings, K=32) in f32 on the card against the NumPy f64 oracle on
   the host, fed the same injected randoms — the gather path and the f32
   dense path, at "highest" matmul precision (checked) and at the default
   precision (reported).  Then the bench's int8 dense contraction against
   the f32 one (checked against the quantization bound of the unit tests).
2. main path: the ml10m config exactly as bench.py builds it, through
   ``MacauEngine.benchmark(40, repeats=1)``, then the same config forced
   onto the int8 dense pair in the same process, so the planner's choice
   of path is checked end to end.
3. probe: the planner's machine constants (ops/dense_gram.py) measured at
   ML-10M and ChEMBL shapes, and the plan every bench.py config resolves
   to under the constants in the code and under the measured ones.

Every phase raises on failure.  The last line of stdout is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.  Without a
GPU, or outside a checkout of the repository, the script exits non-zero
and prints no such line.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K = 32
SEED = 42

# --- tolerances of the reference phase -------------------------------------
# f32 unit roundoff u = 2^-24 ~ 6e-8.  A per-row Gramian entry of the
# ML-10M-shaped data sums up to n ~ 7e4 products (the most-rated item's
# degree); a tree-ordered f32 sum of n terms errs by ~sqrt(n) u ~ 1.6e-5
# relative, and the K x K solve multiplies that by the row precision's
# condition number (<~10 for these posteriors): REF_TOL_U = 2e-4 bounds
# max|U_dev - U_ref| / max|U_ref|.  mu and Lambda reduce N ~ 7e4 factor
# rows with no solve in between: sqrt(N) u ~ 1.6e-5, so REF_TOL_HYPER =
# 2e-5.  A TF32 product (u = 2^-11) would miss both by ~10x, which is why
# the check runs at "highest" precision and the default is only reported.
REF_TOL_U = 2e-4
REF_TOL_HYPER = 2e-5
# int8 dense contraction vs f32 (tests/test_engine.py::
# test_dense_gram_contrib_int8_close): P within 2%, b within 3% of max|.|
INT8_TOL_P = 0.02
INT8_TOL_B = 0.03
# --four-cards: 4-GPU sharded factors vs one GPU after 3 sweeps, both in
# f32 at "highest" precision (int8 and bf16 storage off): the shards sum
# in another order than the single-device einsums and the psums add the
# partials, so the factors differ by f32 rounding, carried through three
# sweeps of the chain.  (With int8 partner quantization on, a rounding
# difference that lands on a quantization boundary moves that value by a
# whole step, 1/127 of its column's max, so the production config agrees
# only to the quantization scale.)
FOUR_CARD_TOL = 1e-4
# probe sizes: a 4 GiB f32 stream, an 8192^3 bf16 GEMM, and the batched
# sampler at the ML-10M and Netflix row counts (K=32) and at K=64/128
COPY_ELEMS = 1 << 30
GEMM_N = 8192
SAMPLER_SHAPES = ((71_567 + 10_681, 32), (480_189, 32), (80_000, 64),
                  (80_000, 128))


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what) -> None:
    """A phase's check: raises (and so fails the run) when ``ok`` is
    false."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def smi() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out[0] if out else "nvidia-smi printed nothing"


def norm_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def timeit(fn, *args, reps: int = 5) -> float:
    """Seconds per call of a jitted fn (compiled and warmed first)."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------------------
# phase 1: reference comparison
# ---------------------------------------------------------------------------

def engine_config(**kw):
    from bench import WIDTHS
    from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
    base = dict(num_latent=K, burnin=1, psamples=0, clamp=(1.0, 5.0),
                verbose=False, dtype="float32", seed=SEED,
                bucket_widths=WIDTHS)
    base.update(kw)
    return MacauConfig(**base)


def reference_phase(rd, num_latent: int = K, tol_u: float = REF_TOL_U,
                    tol_hyper: float = REF_TOL_HYPER):
    """One f32 sweep per path (gather; f32 dense pair) against one f64
    oracle sweep with the same f32 inputs and randoms.

    Returns ``(report, engines)``: report[path][precision] = normalized
    max errors of U, mu, Lambda; engines = {"gather": ..., "dense": ...}.
    Raises AssertionError when a "highest"-precision error exceeds its
    tolerance."""
    import jax
    import jax.numpy as jnp

    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu.utils.rng import draw_all_numpy
    from oracle.oracle import OracleMacau

    paths = {"gather": dict(dense_gram=False),
             "dense": dict(dense_gram=True, dense_int8=False)}
    engines = {}
    for path, kw in paths.items():
        engines[path] = MacauEngine(rd, engine_config(num_latent=num_latent,
                                                      **kw))
    check(not engines["gather"].problem.dense_plans, "gather plan")
    check(engines["dense"].problem.dense_plans
          and not engines["dense"].problem.fused_rels, "dense pair plan")
    key = jax.random.fold_in(jax.random.key(SEED), 0)
    spec = engines["gather"].problem.random_spec
    r32 = {k: np.asarray(v, np.float32) for k, v in
           draw_all_numpy(np.random.default_rng(SEED), spec).items()}
    state0 = engines["gather"].init_state(key)
    t0 = time.perf_counter()
    oracle = OracleMacau(rd, engines["gather"].config)
    ost = oracle.init_state([np.asarray(e["U"], np.float64)
                             for e in state0["ent"]])
    oracle.sweep(ost, {k: v.astype(np.float64) for k, v in r32.items()})
    t_oracle = time.perf_counter() - t0
    report = {"oracle_s": t_oracle}
    for path, eng in engines.items():
        report[path] = {}
        for prec in ("highest", "default"):
            ctx = (jax.default_matmul_precision("highest")
                   if prec == "highest" else contextlib.nullcontext())
            state = eng.init_state(key)
            jr = {k: jnp.asarray(v) for k, v in r32.items()}
            with ctx:
                state, _ = eng._sweep_randoms_jit(eng.problem.arrays,
                                                  state, jr, 0.0)
            st = jax.device_get(state)
            errs = {"U": 0.0, "mu": 0.0, "Lambda": 0.0}
            for ei in range(len(rd.entities)):
                errs["U"] = max(errs["U"], norm_err(st["ent"][ei]["U"],
                                                    ost.U[ei]))
                errs["mu"] = max(errs["mu"], norm_err(st["ent"][ei]["mu"],
                                                      ost.mu[ei]))
                errs["Lambda"] = max(errs["Lambda"], norm_err(
                    st["ent"][ei]["Lambda"], ost.Lambda[ei]))
            report[path][prec] = errs
            if prec == "highest":
                check(errs["U"] <= tol_u
                      and max(errs["mu"], errs["Lambda"]) <= tol_hyper,
                      (path, errs))
    return report, engines


def int8_contraction_check(eng_f32, eng_i8):
    """The bench's int8 dense contraction (s8 store, bf16 small operands)
    against the f32 dense contraction, per mode, same partner factors, no
    ridge; returns {mode: (err_P, err_b)} normalized by max|f32|."""
    import jax
    import jax.numpy as jnp

    from bayesiandatafusion_jl_tpu.ops.dense_gram import dense_gram_contrib
    pf, pi = eng_f32.problem, eng_i8.problem
    st = eng_f32.init_state(jax.random.fold_in(jax.random.key(SEED), 0))
    out = {}
    for mode in range(2):
        plan = pf.dense_plans[(0, mode)]
        dims = list(plan.partner_counts)
        dims.insert(mode, plan.n_focus)
        U = st["ent"][1 - mode]["U"]
        f32 = jax.jit(lambda M, W, U: dense_gram_contrib(
            M, W, [U], mode, dims, jnp.float32, jnp.float32))
        i8 = jax.jit(lambda M, W, U: dense_gram_contrib(
            M, W, [U], mode, dims, jnp.float32, jnp.bfloat16,
            w_scale=pi.dense_w_scale[0]))
        with jax.default_matmul_precision("highest"):
            P0, b0 = f32(pf.arrays["dense"]["r0"]["M"],
                         pf.arrays["dense"]["r0"]["W"], U)
        P1, b1 = i8(pi.arrays["dense"]["r0"]["M"],
                    pi.arrays["dense"]["r0"]["W"], U)
        eP = float(jnp.max(jnp.abs(P1 - P0)) / jnp.max(jnp.abs(P0)))
        eb = float(jnp.max(jnp.abs(b1 - b0)) / jnp.max(jnp.abs(b0)))
        check(eP <= INT8_TOL_P and eb <= INT8_TOL_B, (mode, eP, eb))
        out[mode] = (eP, eb)
    return out


# ---------------------------------------------------------------------------
# phase 3: planner constants and plans
# ---------------------------------------------------------------------------

# Relation statistics of every bench.py config, as its engine sees them
# (train nnz = generated nnz minus the test split).  grid: the values sit
# on an exact (or tol-admitted) small grid, so the fused encoding applies.
PLAN_SPECS = {
    "ml100k": dict(rels=[((943, 1682), 90_000, True)]),
    "ml10m": dict(rels=[((71_567, 10_681), 9_900_054, True)]),
    "sharded1": dict(rels=[((71_567, 10_681), 9_900_054, True)],
                     per_mode=True),
    "chembl": dict(rels=[((15_000, 346), 270_000, False)],
                   feat=(15_000, 32_000, 600_000)),
    "tensor": dict(rels=[((30_000, 2_000, 16), 4_900_000, False)]),
    "tensor_big": dict(rels=[((200_000, 20_000, 8), 29_900_000, False)]),
    "fusion": dict(rels=[((50_000, 500), 4_900_000, False),
                         ((50_000, 3_000), 4_000_000, False),
                         ((50_000, 800), 1_000_000, False)]),
    "netflix": dict(rels=[((480_189, 17_770), 100_380_507, True)],
                    dense_fused=True),
    "netflix_cont": dict(rels=[((480_189, 17_770), 100_380_507, True)],
                         dense_fused=True),
    "netflix_dup": dict(rels=[((480_189, 17_770), 101_880_000, True)],
                        dense_fused=True),
    "netflix_gather": dict(rels=[((480_189, 17_770), 100_380_507, True)],
                           dense_gram=False),
    "netflix_sharded1": dict(rels=[((480_189, 17_770), 100_380_507, True)],
                             per_mode=True, dense_fused=True),
}


def resolve_plan(spec, budget_gb: float = 9.0) -> str:
    """The plan the engines' planner picks from relation statistics alone
    (int8 storage, K=32): 'r0m0=pair r0m1=fused ... e0.X=dense'."""
    from bayesiandatafusion_jl_tpu.ops import dense_gram as dg
    rels = spec["rels"]
    dgm = spec.get("dense_gram")
    shapes = [r[0] for r in rels]
    nnzs = [r[1] for r in rels]
    enc = [(1.0, 0) if r[2] else None for r in rels]
    item = [1] * len(rels)
    fused, spent = dg.plan_fused_rels(shapes, nnzs, K, dgm,
                                      spec.get("dense_fused"), enc, item,
                                      budget_gb * 1e9)
    plans, _, _ = dg.plan_dense_modes(
        shapes, [0 if ri in fused else n for ri, n in enumerate(nnzs)], K,
        dgm, budget_gb * 1e9 - spent, item,
        per_mode_pairs=spec.get("per_mode", False))
    parts = []
    for ri, shape in enumerate(shapes):
        for mode in range(len(shape)):
            parts.append(f"r{ri}m{mode}=" + (
                "fused" if ri in fused else
                "pair" if (ri, mode) in plans else "gather"))
    if "feat" in spec:
        n, f, nnz = spec["feat"]
        if dg.use_dense_feat(n, f, nnz, 1, dgm):
            parts.append("e0.X=dense")
    return " ".join(parts)


def gemm_lowering(fn, *args) -> str:
    """What XLA made of the matrix products in ``fn``: the custom-call
    targets (cuBLAS / cuBLASLt), Triton GEMM fusions, and dots left to
    XLA's own emitters, read from the optimized HLO."""
    import collections
    import re
    txt = fn.lower(*args).compile().as_text()
    cc = collections.Counter(re.findall(r'custom_call_target="([^"]+)"',
                                        txt))
    kinds = collections.Counter(
        k for k in re.findall(r'"kind":"([^"]+)"', txt) if "triton" in k
        or "gemm" in k or "cublas" in k)
    dots = len(re.findall(r"\bdot\(", txt))
    return (f"custom-calls {dict(cc)}, gemm fusion kinds {dict(kinds)}, "
            f"dot ops {dots}")


def probe_phase(eng_gather, eng_f32, eng_i8, tag: str):
    """Measure the planner's machine constants on this card, the batched
    sampler, and how the int8 contractions lowered.  Returns the dict of
    measured values, keyed by their names in ops/dense_gram.py."""
    import jax
    import jax.numpy as jnp

    from bayesiandatafusion_jl_tpu.models.datasets import synthetic_chembl
    from bayesiandatafusion_jl_tpu.ops import dense_gram as dg
    from bayesiandatafusion_jl_tpu.ops.gramian import assemble_precision
    from bayesiandatafusion_jl_tpu.ops.spmv import (build_bucketed_matvec,
                                                    bucketed_spmm)
    from bench import WIDTHS
    out = {}
    C = K * (K + 1) // 2

    # _GATHER_S_PER_OBS: bucketed gather + einsum + segment-sum of both
    # ML-10M modes at the bench's bf16 gram dtype, per observation
    p = eng_gather.problem
    st = eng_gather.init_state(jax.random.key(SEED))
    nnz = p.rel_specs[0].nnz
    t_g = 0.0
    for mode in range(2):
        lay = p.arrays["layouts"][f"r0m{mode}"]
        n = p.entity_specs[mode].n

        def asm(U, lay, n=n):
            contribs = [(jnp.float32(5.0), [U], ba) for ba in lay]
            return assemble_precision(jnp.eye(K, dtype=jnp.float32),
                                      jnp.zeros((n, K), jnp.float32),
                                      contribs, n, gram_dtype=jnp.bfloat16)
        t_g += timeit(jax.jit(asm), st["ent"][1 - mode]["U"], lay)
    out["_GATHER_S_PER_OBS"] = t_g / (2 * nnz)

    # _MATMUL_FLOPS: the bench's s8 dense-pair contraction, both modes
    q = eng_i8.problem
    st8 = eng_i8.init_state(jax.random.key(SEED))
    t_p, cells = 0.0, 0.0
    for mode in range(2):
        plan = q.dense_plans[(0, mode)]
        dims = list(plan.partner_counts)
        dims.insert(mode, plan.n_focus)
        fn = jax.jit(lambda M, W, U, mode=mode, dims=dims: dg.dense_gram_contrib(
            M, W, [U], mode, dims, jnp.float32, jnp.bfloat16,
            w_scale=q.dense_w_scale[0]))
        args = (q.arrays["dense"]["r0"]["M"], q.arrays["dense"]["r0"]["W"],
                st8["ent"][1 - mode]["U"])
        t_mode = timeit(fn, *args)
        t_p += t_mode
        cells += float(dims[0]) * dims[1]
        say(f"lowering: int8 dense pair mode {mode}: "
            f"{gemm_lowering(fn, *args)}; {t_mode * 1e3!r} ms  [{tag}]")
        # the same contraction from a bf16 pair, for comparison
        M16 = eng_f32.problem.arrays["dense"]["r0"]["M"].astype(jnp.bfloat16)
        W16 = eng_f32.problem.arrays["dense"]["r0"]["W"].astype(jnp.bfloat16)
        fn16 = jax.jit(lambda M, W, U, mode=mode, dims=dims:
                       dg.dense_gram_contrib(M, W, [U], mode, dims,
                                             jnp.float32, jnp.bfloat16))
        t16 = timeit(fn16, M16, W16, st8["ent"][1 - mode]["U"])
        say(f"lowering: bf16 dense pair mode {mode}: "
            f"{gemm_lowering(fn16, M16, W16, st8['ent'][1 - mode]['U'])}; "
            f"{t16 * 1e3!r} ms  [{tag}]")
        del M16, W16

    # _BF16_FLOPS: the chunked-mask bf16 fused contraction at ML-10M shape
    rel = eng_i8.rd.relations[0]
    enc = dg.fused_pair_encode(rel.data.idx, rel.data.vals,
                               (p.entity_specs[0].n, p.entity_specs[1].n))
    check(enc is not None, "ML-10M ratings are on a fused grid")
    V8 = dg.build_fused_values_device(rel.data.idx, rel.data.vals,
                                      (p.entity_specs[0].n,
                                       p.entity_specs[1].n), *enc)
    t_f = 0.0
    for mode in range(2):
        fn = jax.jit(lambda V8, U, mode=mode: dg.fused_gram_contrib(
            V8, U, mode, jnp.float32, jnp.bfloat16, enc[0], enc[1], 3.5))
        t_f += timeit(fn, V8, st8["ent"][1 - mode]["U"])
        Ui = st8["ent"][1 - mode]["U"]
        fi8 = jax.jit(lambda V8, U, mode=mode: dg.fused_gram_contrib_i8(
            V8, U, mode, jnp.float32, enc[0], enc[1], 3.5))
        ti8 = timeit(fi8, V8, Ui)
        say(f"lowering: fused s8 contraction mode {mode} (ML-10M V8): "
            f"{gemm_lowering(fi8, V8, Ui)}; {ti8 * 1e3!r} ms; bf16 fused "
            f"{gemm_lowering(fn, V8, Ui)}  [{tag}]")
    del V8

    # _HBM_BPS: a 4 GiB f32 read + write
    x = jnp.ones((COPY_ELEMS,), jnp.float32)
    t_c = timeit(jax.jit(lambda x: x * 1.5 + 1.0), x)
    out["_HBM_BPS"] = 2.0 * x.nbytes / t_c
    del x
    # the planner models a dense mode as max(2 cells C / rate, cells / BW)
    # + cells / BW (estimate_times, int8 cells): the rates below are the
    # ones for which that model reproduces the measured time of both modes
    for name, t in (("_MATMUL_FLOPS", t_p), ("_BF16_FLOPS", t_f)):
        t_mm = t - cells / out["_HBM_BPS"]
        out[name] = 2.0 * cells * C / max(t_mm, cells / out["_HBM_BPS"])
        out[name + "_raw_s"] = t

    # _SPMM_S_PER_NNZ: bucketed X'(X v) on the ChEMBL bench feature matrix
    rd_c = synthetic_chembl(n_compounds=15_000, n_targets=346,
                            n_features=32_000, nnz=300_000, seed=3)
    F = rd_c.entities[0].F
    mv = build_bucketed_matvec(F.rows, F.cols, F.shape, vals=F.vals,
                               widths=WIDTHS, dtype=np.float32)
    mv = jax.tree.map(jnp.asarray, mv)
    v = jnp.asarray(np.random.default_rng(0).standard_normal(
        (F.shape[1], K)), jnp.float32)
    fn = jax.jit(lambda mv, v: bucketed_spmm(
        mv["t"], F.shape[1], bucketed_spmm(mv["fwd"], F.shape[0], v)))
    out["_SPMM_S_PER_NNZ"] = timeit(fn, mv, v) / (2 * F.nnz)

    # the batched sampler alone (ops/mvn.chol_sample), f32
    from bayesiandatafusion_jl_tpu.ops.mvn import chol_sample

    def spd(k, n, kk):
        A = jax.random.normal(k, (n, kk, kk), jnp.float32) * 0.3
        return A @ jnp.swapaxes(A, 1, 2) + kk * jnp.eye(kk)
    samp = jax.jit(chol_sample)
    for n, kk in SAMPLER_SHAPES:
        P = jax.jit(spd, static_argnums=(1, 2))(jax.random.key(1), n, kk)
        b = jnp.ones((n, kk), jnp.float32)
        t = timeit(samp, P, b, b)
        say(f"sampler: chol_sample [{n}, {kk}, {kk}] f32: {t * 1e3!r} ms; "
            f"{gemm_lowering(samp, P, b, b)}  [{tag}]")
        out[f"chol_sample_{n}x{kk}_s"] = t
        del P

    # a plain large bf16 GEMM, for scale
    a = jnp.ones((GEMM_N, GEMM_N), jnp.bfloat16)
    t_mm = timeit(jax.jit(lambda a: a @ a), a)
    out["bf16_gemm_flops"] = 2.0 * GEMM_N ** 3 / t_mm
    for name, val in out.items():
        if name.startswith("_") or name.endswith("flops"):
            say(f"probe: {name} = {val!r}  [{tag}]")
    return out


def print_plans(measured, tag: str):
    from bayesiandatafusion_jl_tpu.ops import dense_gram as dg
    names = ("_GATHER_S_PER_OBS", "_MATMUL_FLOPS", "_BF16_FLOPS",
             "_HBM_BPS", "_SPMM_S_PER_NNZ")
    in_code = {n: getattr(dg, n) for n in names}
    # (the planner's budget notes on stderr are expected here)
    with contextlib.redirect_stderr(io.StringIO()):
        plans_code = {c: resolve_plan(s) for c, s in PLAN_SPECS.items()}
        try:
            for n in names:
                setattr(dg, n, measured[n])
            plans_meas = {c: resolve_plan(s) for c, s in PLAN_SPECS.items()}
        finally:
            for n, v in in_code.items():
                setattr(dg, n, v)
    for c in PLAN_SPECS:
        flag = "" if plans_code[c] == plans_meas[c] else "  CHANGED"
        say(f"plan: {c}: constants in code: {plans_code[c]} | measured: "
            f"{plans_meas[c]}{flag}  [{tag}]")


# ---------------------------------------------------------------------------
# the phases
# ---------------------------------------------------------------------------

def default_phases(tag: str):
    import dataclasses

    import jax

    import bench
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine

    # the bench's ml10m engine (its planner's choice of path) and the same
    # config forced onto the int8 dense pair
    t0 = time.perf_counter()
    eng_auto, df, _real = bench._ml_engine("10m", 40)
    rd = eng_auto.rd
    eng_i8 = MacauEngine(rd, dataclasses.replace(eng_auto.config,
                                                 dense_gram=True))
    say(f"data: ML-10M-shaped {df.shape}, nnz={df.nnz}, train "
        f"{rd.relations[0].data.nnz}; bench engine (plan "
        f"{bench.plan_summary(eng_auto.problem)}) and int8 dense-pair engine "
        f"built in {time.perf_counter() - t0:.1f} s  [{tag}]")

    # 1. reference comparison at ML-10M width
    t0 = time.perf_counter()
    report, engines = reference_phase(rd)
    say(f"reference: oracle sweep {report['oracle_s']:.1f} s on the host; "
        f"phase {time.perf_counter() - t0:.1f} s  [{tag}]")
    for path in ("gather", "dense"):
        for prec in ("highest", "default"):
            e = report[path][prec]
            say(f"reference: {path} f32 @ {prec} precision vs f64 oracle: "
                f"max|dU|/max|U| = {e['U']!r}, mu {e['mu']!r}, Lambda "
                f"{e['Lambda']!r} (tol U {REF_TOL_U}, mu/Lambda "
                f"{REF_TOL_HYPER}{'' if prec == 'highest' else ', reported'})"
                f"  [{tag}]")
    for mode, (eP, eb) in int8_contraction_check(engines["dense"],
                                                 eng_i8).items():
        say(f"reference: int8 dense contraction mode {mode} vs f32: "
            f"max|dP|/max|P| = {eP!r} (tol {INT8_TOL_P}), max|db|/max|b| = "
            f"{eb!r} (tol {INT8_TOL_B})  [{tag}]")

    # 2. main path: the bench's ml10m engine, 40-sweep windows; then the
    # forced int8 dense pair in the same process, for comparison
    n_rows = sum(es.n for es in eng_auto.problem.entity_specs)
    for label, eng in (("ml10m (bench plan)", eng_auto),
                       ("ml10m forced int8 dense pair", eng_i8)):
        t0 = time.perf_counter()
        out = eng.benchmark(40, repeats=1)
        wall = time.perf_counter() - t0
        ms = out["ms_per_sweep"][0]
        m = out["metrics"]
        rmse40 = out["rmse_at_sweeps"]
        check(np.isfinite(rmse40) and np.isfinite(m["r0.rmse_avg"]),
              (label, out))
        stats = jax.devices()[0].memory_stats() or {}
        say(f"main: {label} MacauEngine.benchmark(40): ms/sweep={ms!r}, "
            f"rows/s={n_rows / ms * 1e3!r}, rmse_sample@40={rmse40!r}, "
            f"rmse_avg={m['r0.rmse_avg']!r}, compile_s~"
            f"{wall - 2 * 40 * ms / 1e3:.1f} (warm window minus a timed "
            f"one), process peak_bytes_in_use="
            f"{stats.get('peak_bytes_in_use')}, plan "
            f"{bench.plan_summary(eng.problem)}  [{tag}]")

    # 3. planner probe
    measured = probe_phase(engines["gather"], engines["dense"], eng_i8, tag)
    print_plans(measured, tag)
    del engines, eng_i8, eng_auto


# most informative first: a time limit cuts the tail of the list
ALL_CONFIGS = ("ml10m", "netflix", "ml100k", "fusion", "tensor", "chembl",
               "sharded1", "netflix_gather", "netflix_cont", "netflix_dup",
               "netflix_sharded1", "tensor_big")


def all_configs(tag: str, time_limit: float):
    """One warm + one timed window of every bench.py config, each in a
    child process of its own (this process keeps no card memory).  A
    config that fails is reported and the others still run; the run fails
    at the end.  No config starts after ``time_limit`` seconds, and a
    running one is killed at that limit."""
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_PYTHON_CLIENT_PREALLOCATE"}
    env["BENCH_REPEATS"] = "1"
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    t_start = time.perf_counter()
    failed, skipped = [], []
    for cfg in ALL_CONFIGS:
        left = time_limit - (time.perf_counter() - t_start)
        if left < 30:
            skipped.append(cfg)
            continue
        env["BENCH_CONFIG"] = cfg
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable,
                                os.path.join(ROOT, "bench.py")],
                               cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=left)
        except subprocess.TimeoutExpired:
            say(f"config {cfg}: killed at the time limit after "
                f"{time.perf_counter() - t0:.0f} s  [{tag}]")
            skipped.append(cfg)
            continue
        wall = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"bench_{cfg}.log"), "w") as f:
            f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
        if r.returncode != 0:
            failed.append(cfg)
            say(f"config {cfg}: FAILED ({r.returncode}) after {wall:.0f} s: "
                f"{r.stderr.strip().splitlines()[-1:]}  [{tag}]")
            continue
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        say(f"config {cfg}: ms/sweep={rec.get('ms_per_sweep')!r} "
            f"value={rec.get('value')!r} {rec.get('unit')} wall={wall:.0f}s"
            f"  [{tag}]")
        for ln in r.stderr.splitlines():
            if ": plan " in ln or "peak_bytes" in ln:
                say(f"config {cfg}: {ln.lstrip('# ')}")
    if skipped:
        say(f"configs not run within {time_limit:.0f} s: {skipped}")
    check(not failed, f"configs failed: {failed}")


def four_cards(tag: str):
    """ml10m and netflix on a 4-GPU data mesh vs MacauEngine on one GPU,
    same key, 3 sweeps each, in f32 (see FOUR_CARD_TOL)."""
    import dataclasses

    import jax

    import bench
    from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
    from bayesiandatafusion_jl_tpu.parallel.mesh import data_mesh
    from bayesiandatafusion_jl_tpu.parallel.sharded import (
        ShardedMacauEngine)
    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devs)}")
    mesh = data_mesh(devs[:4])
    for name in ("ml10m", "netflix"):
        rd, cfg = bench.build_problem(name)
        # f32 storage everywhere; the budget keeps the sharded engine's
        # per-mode f32 pairs on the same (dense) plan as the plain engine
        cfg = dataclasses.replace(cfg, dense_int8=False, gram_dtype=None,
                                  dense_gram_budget_gb=20.0)
        res = {}
        with jax.default_matmul_precision("highest"):
            for label in ("1 GPU", "4 GPUs"):
                t0 = time.perf_counter()
                if label == "1 GPU":
                    eng = MacauEngine(rd, cfg)
                    r = eng.run(num_sweeps=3)
                    U = [np.asarray(r["state"]["ent"][ei]["U"])
                         for ei in range(len(rd.entities))]
                else:
                    eng = ShardedMacauEngine(rd, cfg, mesh=mesh)
                    r = eng.run(num_sweeps=3)
                    U = eng.factors_original_order(r["state"][0])
                res[label] = (U, time.perf_counter() - t0,
                              bench.plan_summary(eng.problem),
                              r["history"][-1]["r0.rmse_sample"])
                del eng, r
        (U1, t1, p1, rm1), (U4, t4, p4, rm4) = res["1 GPU"], res["4 GPUs"]
        errs = [norm_err(U4[ei], U1[ei]) for ei in range(len(U1))]
        say(f"four-cards: {name} (f32): 4-GPU sharded vs 1-GPU factors "
            f"after 3 sweeps: max|dU|/max|U| = {max(errs)!r} (tol "
            f"{FOUR_CARD_TOL}); rmse_sample@3 {rm4!r} vs {rm1!r}; wall 1 GPU "
            f"{t1:.1f} s, 4 GPUs {t4:.1f} s (build, compile, 3 sweeps); "
            f"plan {p1} | {p4}  [{tag}]")
        check(max(errs) <= FOUR_CARD_TOL
              and np.isfinite(rm1) and np.isfinite(rm4), (name, errs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--all-configs", action="store_true")
    g.add_argument("--four-cards", action="store_true")
    ap.add_argument("--time-limit", type=float, default=3600.0,
                    help="--all-configs: seconds after which no config "
                    "starts and a running one is killed")
    args = ap.parse_args(argv)
    if args.all_configs:
        # the children take the card; this process only checks for it
        os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    sys.path.insert(0, ROOT)

    import jax

    from bayesiandatafusion_jl_tpu import native
    from bayesiandatafusion_jl_tpu.utils.compile_cache import \
        enable_compile_cache
    card = smi()
    say(f"card: {card}")
    devs = jax.devices()
    say(f"jax: {jax.__version__} devices {devs}")
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    lib = native.lib()
    say(f"native: {'loaded' if lib is not None else 'NOT loaded'} "
        f"({native._SO}); compile cache {cache}")
    if lib is None:
        raise RuntimeError("native data layer did not build or load")
    tag = f"{devs[0].device_kind} | {card}"
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(tag)
    elif args.all_configs:
        all_configs(tag, args.time_limit)
    else:
        default_phases(tag)
    say(f"total: {time.perf_counter() - t0:.1f} s  [{tag}]")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
