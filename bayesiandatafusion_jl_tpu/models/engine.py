"""The Gibbs sweep engine — ``macau()`` (reference: src/macau.jl [HIGH]).

Orchestration follows SURVEY.md §4.6 exactly:

  for sweep in 1..(burnin + psamples):
    for e in entities (sequential scan):
      if has_features(e): sample beta_e (noise-injected solve, §4.4);
                          lambda_beta_e Gibbs (§4.5); uhat = X beta
      (mu_e, Lambda_e) <- Normal-Wishart on U_e - uhat (§4.3)
      all rows of U_e  <- batched precision-assembly + Cholesky MVN (§4.2)
    for r in relations: optional alpha_r Gibbs from train residuals (§4.5)
    predict test tuples, clamp per sample, accumulate posterior mean (§4.7)

Design: the whole sweep is ONE jitted function over static-shaped
bucketed layouts (ops/layout.py) — no retracing, no host round-trips inside
a sweep.  Randomness comes from a pre-built randoms pytree (utils/rng.py)
so the engine has an injection seam for oracle equivalence, and the default
threefry path is sharding-stable.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.lax import linalg as lxl

from ..ops import layout as layout_mod
from ..ops.cg import block_cg
from ..ops.spmv import bucketed_spmm
from ..ops.dense_gram import dense_gram_contrib
from ..ops.gramian import (assemble_precision,
                           assemble_precision_planned,
                           predict_tuples)
from ..ops.hyper import (normal_wishart_update, sample_alpha,
                         sample_lambda_beta)
from ..ops.mvn import chol_sample_dispatch
from ..utils.compile_cache import enable_compile_cache
from ..utils.config import MacauConfig
from ..utils.rng import DrawSpec, RandomSpec, draw_all, sweep_key
from .data import (RelationData, resolved_alpha, resolved_alpha_sample,
                   resolved_lambda_beta)


# ---------------------------------------------------------------------------
# Static problem description (hashable; closed over by the jitted sweep)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EntitySpec:
    name: str
    n: int
    num_features: int
    use_ff: bool           # direct X'X path vs blocked CG (SURVEY §4.4)
    feat_nnz: int
    # "ff" | "cg" | "dual" (ops/dual.py Woodbury exact solve); use_ff is
    # kept as the derived boolean for back-compat
    solver: str = "cg"

    @property
    def has_features(self) -> bool:
        return self.num_features > 0


@dataclasses.dataclass(frozen=True)
class RelationSpec:
    name: str
    arity: int
    entity_ids: Tuple[int, ...]   # mode -> entity index
    nnz: int
    n_test: int
    alpha_sample: bool
    mean_value: float
    class_cut: Optional[float]


class CompiledProblem:
    """Device arrays + static metadata for one RelationData graph."""

    def __init__(self, rd: RelationData, config: MacauConfig):
        self.config = config
        K = config.num_latent
        dtype = config.np_dtype()

        self.entity_specs: List[EntitySpec] = []
        ent_index = {id(e): i for i, e in enumerate(rd.entities)}
        self.rel_specs: List[RelationSpec] = []

        arrays: Dict[str, Any] = {"layouts": {}, "feat": {}, "ftf": {},
                                  "test": {}, "train": {}, "acc_plan": {},
                                  "dense": {}}
        # bucket shape metadata per (relation, mode) key (static)
        self.layout_meta: Dict[str, List[Tuple[int, int]]] = {}
        host_inst: Dict[str, List[np.ndarray]] = {}

        # dense Gramian plan (ops/dense_gram.py): modes that replace the
        # observation gather with M @ Y matmuls skip the bucketed layout
        from ..ops import dense_gram as dg
        store_np = (np.float32 if config.gram_dtype == "bfloat16"
                    else config.np_dtype())
        store_jnp = (jnp.bfloat16 if config.gram_dtype == "bfloat16"
                     else jnp.dtype(config.dtype))
        # int8 eligibility is decided from the observation index (layout-
        # invariant) so this engine and the sharded one always agree
        i8_ok = [config.dense_int8
                 and dg.int8_pair_ok(rel.data.idx,
                                     [e.count for e in rel.entities])
                 for rel in rd.relations]
        base_item = jnp.dtype(store_jnp).itemsize
        pair_item = [1 if ok else base_item for ok in i8_ok]
        shapes = [tuple(e.count for e in rel.entities)
                  for rel in rd.relations]
        # single-array fused path (sparse regime, VERDICT r2 #1): encoding
        # + engagement are relation-statistics-only so both engines agree.
        # fused_pair_plan may mark a RESIDUAL subset (duplicates, zero-code
        # level, and nothing else) that rides the bucketed gather path with
        # exact values — the hybrid's contributions add (VERDICT r3 #2).
        fused_enc = [None] * len(rd.relations)
        fused_keep_all: Dict[int, np.ndarray] = {}
        if config.dense_fused is not False and config.dense_gram is not False:
            for ri, rel in enumerate(rd.relations):
                if (rel.arity == 2 and rel.data.nnz
                        and (config.dense_fused
                             or rel.data.nnz >= dg._AUTO_MIN_NNZ)):
                    plan = dg.fused_pair_plan(
                        rel.data.idx, rel.data.vals, shapes[ri],
                        tol=config.dense_fused_tol)
                    if plan is not None:
                        fused_enc[ri] = plan[:2]
                        fused_keep_all[ri] = plan[2]
        self.fused_rels, fused_spent = dg.plan_fused_rels(
            shapes, [rel.data.nnz for rel in rd.relations], K,
            config.dense_gram, config.dense_fused, fused_enc, pair_item,
            config.dense_gram_budget_gb * 1e9)
        self.dense_plans, _dense_canon, _dense_copies = dg.plan_dense_modes(
            shapes,
            [0 if ri in self.fused_rels else rel.data.nnz
             for ri, rel in enumerate(rd.relations)], K,
            config.dense_gram,
            config.dense_gram_budget_gb * 1e9 - fused_spent,
            pair_item)
        # fused s8 variant: opt-in via dense_int8 like the pair path,
        # gated on int32-overflow eligibility.  Decided from the encoding
        # + true shape only so the single-device and sharded engines
        # always agree.
        self.fused_i8: Dict[int, bool] = {}
        # ri -> bool keep mask when the fused relation has a gather-path
        # residual (None entries never stored; empty dict = no hybrids)
        self.fused_keep: Dict[int, np.ndarray] = {}
        for ri, _enc in self.fused_rels.items():
            rel = rd.relations[ri]
            kp = fused_keep_all[ri]
            if not kp.all():
                self.fused_keep[ri] = kp
            idx_k = rel.data.idx if kp.all() else rel.data.idx[kp]
            vals_k = rel.data.vals if kp.all() else rel.data.vals[kp]
            self.fused_i8[ri] = bool(
                config.dense_int8
                and dg.fused_int8_ok(
                    dg.fused_code_bound(vals_k, *_enc),
                    shapes[ri], idx=idx_k,
                    abs_codes=dg.fused_abs_codes(vals_k, *_enc)))
            arrays["dense"][f"r{ri}"] = {"V8": dg.build_fused_values_device(
                idx_k, vals_k, shapes[ri], *_enc)}
            if self.fused_i8[ri]:
                # static per-mode observation counts for the int8 PD ridge
                # (fused-path observations only: the residual's values are
                # exact, so it adds no quantization noise to bound)
                for mode in range(2):
                    deg = np.bincount(idx_k[:, mode],
                                      minlength=shapes[ri][mode])
                    arrays["dense"][f"r{ri}"][f"deg_m{mode}"] = \
                        jnp.asarray(deg, jnp.float32)
            for mode in range(2):
                self.dense_plans[(ri, mode)] = dg.DenseModePlan(
                    "fused", shapes[ri][mode],
                    (shapes[ri][1 - mode],))
        self.dense_w_scale: Dict[int, float] = {}  # ri -> static int8 scale
        for ri in sorted(_dense_canon):
            rel = rd.relations[ri]
            dims = [e.count for e in rel.entities]
            M, W = dg.build_dense_pair(
                rel.data.idx, rel.data.vals - float(rel.data.vals.mean()),
                dims, store_np)
            q8 = dg.quantize_dense_pair(M, W) if i8_ok[ri] else None
            if q8 is not None:
                M8, W8, self.dense_w_scale[ri] = q8
                arrays["dense"][f"r{ri}"] = {"M": jnp.asarray(M8),
                                             "W": jnp.asarray(W8)}
                # static per-mode observation counts for the int8 PD ridge
                for mode in range(rel.arity):
                    deg = np.bincount(rel.data.idx[:, mode],
                                      minlength=dims[mode])
                    arrays["dense"][f"r{ri}"][f"deg_m{mode}"] = \
                        jnp.asarray(deg, jnp.float32)
                del M8, W8
            else:
                arrays["dense"][f"r{ri}"] = {"M": jnp.asarray(M, store_jnp),
                                             "W": jnp.asarray(W, store_jnp)}
            del M, W

        for ri, rel in enumerate(rd.relations):
            mean_value = float(rel.data.vals.mean()) if rel.data.nnz else 0.0
            eids = tuple(ent_index[id(e)] for e in rel.entities)
            self.rel_specs.append(RelationSpec(
                name=rel.name, arity=rel.arity, entity_ids=eids,
                nnz=rel.data.nnz, n_test=len(rel.test_vals),
                alpha_sample=resolved_alpha_sample(rel, config),
                mean_value=mean_value,
                class_cut=rel.class_cut))
            centered = rel.data.vals - mean_value
            # hybrid fused relations: the residual observations (exact
            # values) get normal bucketed layouts; their contributions add
            # to the fused mode's in the sweep
            resid = (np.nonzero(~self.fused_keep[ri])[0]
                     if ri in self.fused_keep else None)
            for mode in range(rel.arity):
                if (ri, mode) in self.dense_plans and resid is None:
                    key = f"r{ri}m{mode}"
                    self.layout_meta[key] = []
                    host_inst[key] = []
                    arrays["layouts"][key] = []
                    continue
                l_idx = rel.data.idx if resid is None else rel.data.idx[resid]
                l_cen = centered if resid is None else centered[resid]
                ml = layout_mod.build_mode_layout(
                    l_idx, l_cen, mode,
                    rel.entities[mode].count,
                    widths=config.bucket_widths, row_pad=config.row_pad,
                    dtype=dtype)
                key = f"r{ri}m{mode}"
                self.layout_meta[key] = [(b.n_rows, b.width)
                                         for b in ml.buckets]
                host_inst[key] = [b.inst for b in ml.buckets]
                arrays["layouts"][key] = [
                    {"inst": jnp.asarray(b.inst),
                     "part": [jnp.asarray(p) for p in b.part],
                     "val": jnp.asarray(b.val, dtype),
                     "mask": jnp.asarray(b.mask, dtype)}
                    for b in ml.buckets]
            if rel.test_idx.shape[0]:
                arrays["test"][f"r{ri}"] = {
                    "idx": jnp.asarray(rel.test_idx),
                    "vals": jnp.asarray(rel.test_vals, dtype)}
            if resolved_alpha_sample(rel, config):
                arrays["train"][f"r{ri}"] = {
                    "idx": jnp.asarray(rel.data.idx),
                    "vals": jnp.asarray(centered, dtype)}

        for ei, ent in enumerate(rd.entities):
            nf = ent.num_features
            use_ff = False
            solver = "cg"
            if nf:
                pref = ent.use_ff if ent.use_ff is not None else config.use_ff
                use_ff = (nf <= config.ff_threshold) if pref is None else bool(pref)
                F = ent.F
                from ..ops.spmv import build_bucketed_matvec
                arrays["feat"][f"e{ei}"] = {
                    "mv": build_bucketed_matvec(
                        F.rows, F.cols, F.shape, vals=F.vals,
                        widths=config.bucket_widths,
                        row_pad=config.row_pad, dtype=dtype),
                    "colcount": jnp.asarray(F.col_sq_sums().astype(dtype))}
                # dense [N, F] matvec operand (ops/dense_gram.py): binary
                # features are exact in bf16; real-valued stay in the
                # compute dtype so the CG operator is unchanged
                fx_jnp = store_jnp if F.is_binary else jnp.dtype(dtype)
                if F.is_binary and store_jnp == jnp.bfloat16:
                    # binary X is exact in any dtype; int8 halves the
                    # memory stream of the bandwidth-bound CG matvec (the
                    # int8 -> bf16 convert fuses into the dot)
                    fx_jnp = jnp.int8
                if dg.use_dense_feat(ent.count, nf, F.nnz,
                                     jnp.dtype(fx_jnp).itemsize,
                                     config.dense_gram):
                    Xd = np.zeros((ent.count, nf),
                                  np.float32 if fx_jnp == jnp.bfloat16
                                  else dtype)
                    np.add.at(Xd, (F.rows, F.cols), F.values())
                    arrays["feat"][f"e{ei}"]["dense_X"] = \
                        jnp.asarray(Xd, fx_jnp)
                    del Xd
                from ..ops import dual as dual_mod
                solver = "ff" if use_ff else "cg"
                if not use_ff and dual_mod.use_dual(
                        config.beta_solver, ent.count, nf,
                        dtype.itemsize, config.dual_budget_gb):
                    solver = "dual"
                    Qd, dd, G = dual_mod.dual_eig_cached(
                        F.rows, F.cols, F.values(), F.shape, dtype,
                        config.dual_cache_dir)
                    arrays["feat"][f"e{ei}"]["dual_Q"] = jnp.asarray(Qd)
                    arrays["feat"][f"e{ei}"]["dual_d"] = jnp.asarray(dd)
                    # exact G for the N-space refinement (dual_solve_g)
                    arrays["feat"][f"e{ei}"]["dual_G"] = jnp.asarray(
                        G.astype(dtype))
                    del G, Qd, dd
                from ..ops.precond import resolve_nystrom_rank
                nys_rank = resolve_nystrom_rank(config.cg_nystrom_rank, nf)
                if solver == "cg" and nys_rank and nf >= 4 * nys_rank:
                    from ..ops.precond import build_nystrom
                    Un, dn = build_nystrom(
                        F.rows, F.cols, F.values(), F.shape,
                        nys_rank, seed=config.seed)
                    arrays["feat"][f"e{ei}"]["nys_U"] = \
                        jnp.asarray(Un, dtype)
                    arrays["feat"][f"e{ei}"]["nys_d"] = \
                        jnp.asarray(dn, dtype)
                    del Un, dn
                if use_ff:
                    try:
                        import scipy.sparse as sp
                        X = sp.coo_matrix(
                            (F.values().astype(dtype), (F.rows, F.cols)),
                            shape=F.shape).tocsr()
                        ftf = np.asarray((X.T @ X).todense(), dtype)
                    except ImportError:  # pragma: no cover
                        ftf = F.gram().astype(dtype)
                    arrays["ftf"][f"e{ei}"] = jnp.asarray(ftf)
            self.entity_specs.append(EntitySpec(
                name=ent.name, n=ent.count, num_features=nf,
                use_ff=use_ff, feat_nnz=(ent.F.nnz if nf else 0),
                solver=(solver if nf else "cg")))

        # accumulation plans: static first-row gather + overflow per entity,
        # in the exact contribs order the sweep uses (ops/gramian.py)
        from ..ops.gramian import plan_accumulation
        for ei, ent in enumerate(rd.entities):
            inst_list = []
            for ri, rs in enumerate(self.rel_specs):
                for mode in range(rs.arity):
                    if rs.entity_ids[mode] != ei:
                        continue
                    inst_list.extend(host_inst[f"r{ri}m{mode}"])
            plan = plan_accumulation(inst_list, ent.count)
            arrays["acc_plan"][f"e{ei}"] = {
                k: jnp.asarray(v) for k, v in plan.items()}

        self.arrays = arrays
        # per-entity initial hyper values: model override else config
        # (shared precedence with the oracle — resolved_* in models/data.py)
        self.init_lambda_beta = [resolved_lambda_beta(e, config)
                                 for e in rd.entities]
        self.init_alpha = [resolved_alpha(r, config) for r in rd.relations]
        self.random_spec = build_random_spec(self.entity_specs,
                                             self.rel_specs, config)

    def flops_per_sweep(self) -> float:
        """Approximate matmul work of one sweep.  Diagnostic only —
        bench.py divides by the measured ms/sweep to report effective
        TOPS; no engine decision reads this.

        Counts the Gramian/rhs assembly (dense modes: the full M/W
        contraction, padded cells included — that IS the executed work;
        gather modes: per-observation outer products) PLUS the beta
        link-matrix solver's matmuls (VERDICT r4 weak #4: ChEMBL's
        dual-solver work — ~14x its Gramian flops — made effective_tops
        read 1.0).  The CG path counts only its deterministic passes
        (rhs build + uhat); per-iteration matvecs depend on the runtime
        iteration count, so the CG config modestly UNDERCOUNTS."""
        K = self.config.num_latent
        C = K * (K + 1) // 2
        counts = [es.n for es in self.entity_specs]
        f = 0.0
        for ri, rs in enumerate(self.rel_specs):
            total = float(np.prod([counts[e] for e in rs.entity_ids]))
            for mode in range(rs.arity):
                if (ri, mode) in self.dense_plans:
                    f += 2.0 * total * (C + K)
                else:
                    f += 2.0 * rs.nnz * (K * K + K)
        for es in self.entity_specs:
            if not es.has_features:
                continue
            N, F = float(es.n), float(es.num_features)
            xpass = 2.0 * N * F * K          # one X @ / X' @ [., K] pass
            f += xpass                       # rhs build (X' resid)
            if es.use_ff:
                f += F ** 3 / 3.0 + 2.0 * F * F * K + xpass   # chol+solve+uhat
            elif es.solver == "dual":
                r = float(self.config.dual_refine)
                # dual_solve_g: spmm_fwd + spmm_t, (1+r) apply_inv
                # (2 matmuls each), r exact-G residuals (ops/dual.py)
                f += 2.0 * xpass + (4.0 * (1.0 + r) + 2.0 * r) * N * N * K
            else:
                f += xpass                   # uhat (CG iterations uncounted)
        return f


def build_random_spec(entity_specs, rel_specs, cfg: MacauConfig) -> RandomSpec:
    """Randoms specification — static shapes only (SURVEY §9.2 RNG seam).

    Shared by the single-device and sharded engines so that both consume
    identical threefry streams (draws are made in the ORIGINAL instance
    order; the sharded engine permutes them into its hash-partitioned
    layout), which is what makes results sharding-independent.
    """
    K = cfg.num_latent
    nu0 = cfg.resolved_nu0()
    spec: RandomSpec = {}
    for ei, es in enumerate(entity_specs):
        N = es.n
        nu_star = nu0 + N
        spec[f"e{ei}.nw_g"] = DrawSpec(
            "gamma", (K,),
            tuple((nu_star - i) / 2.0 for i in range(K)))
        spec[f"e{ei}.nw_tri"] = DrawSpec("normal", (K, K))
        spec[f"e{ei}.nw_mu"] = DrawSpec("normal", (K,))
        spec[f"e{ei}.xi"] = DrawSpec("normal", (N, K))
        if es.has_features:
            F = es.num_features
            spec[f"e{ei}.beta_e1"] = DrawSpec("normal", (N, K))
            spec[f"e{ei}.beta_e2"] = DrawSpec("normal", (F, K))
            if cfg.sample_lambda_beta:
                spec[f"e{ei}.lb_g"] = DrawSpec(
                    "gamma", (), ((cfg.nu_beta + F * K) / 2.0,))
    for ri, rs in enumerate(rel_specs):
        if rs.alpha_sample:
            spec[f"r{ri}.alpha_g"] = DrawSpec(
                "gamma", (), (cfg.alpha_a0 + rs.nnz / 2.0,))
    return spec


# ---------------------------------------------------------------------------
# Shared driver loop (used by MacauEngine and ShardedMacauEngine so the
# aux subsystems — metrics batching, jsonl log, posterior dumps,
# checkpointing, tracing, verbose — behave identically; SURVEY §7)
# ---------------------------------------------------------------------------

class GibbsDriverMixin:
    """run() loop over `_do_sweep`; subclasses provide `_do_sweep`,
    `_results`, `_save_sample`, `save_state`, `init_state`."""

    def run(self, state=None, key: Optional[jax.Array] = None,
            num_sweeps: Optional[int] = None,
            sweep_offset: int = 0,
            callback=None) -> Dict[str, Any]:
        """Run burnin + psamples sweeps; returns the reference-style results.

        ``callback(sweep, phase, metrics, dt)`` is invoked per sweep.
        Metric fetches sync the device pipeline; they are gated by
        ``config.metrics_every`` unless verbose/log/callback forces them.
        """
        cfg = self.config
        if key is None:
            key = jax.random.key(cfg.seed)
        if state is None:
            state = self.init_state(jax.random.fold_in(key, 0))
        total = (cfg.burnin + cfg.psamples if num_sweeps is None
                 else num_sweeps)
        history = []
        log_f = open(cfg.log_file, "a") if cfg.log_file else None
        begin = getattr(self, "_begin_run", None)
        if begin is not None:
            begin()
        spd = max(getattr(cfg, "sweeps_per_dispatch", 1), 1)
        batch_fn = getattr(self, "_do_sweeps_batch", None)
        every = max(cfg.metrics_every, 1)
        try:
            s = sweep_offset
            while s < total:
                trace_this = (cfg.trace_dir is not None
                              and s == min(2, total - 1))
                n = 1
                if spd > 1 and batch_fn is not None and not trace_this:
                    n = min(spd, self._chunk_limit(s, total) - s)
                t0 = time.perf_counter()
                if n == 1:
                    if trace_this:
                        jax.profiler.start_trace(cfg.trace_dir)
                    skey = sweep_key(key, s + 1)
                    accumulate = 1.0 if s >= cfg.burnin else 0.0
                    state, mstack = self._do_sweep(
                        state, skey, accumulate, tag=s,
                        key_fn=lambda i: sweep_key(key, i + 1))
                    pick = lambda v, j: v  # noqa: E731
                else:
                    # one lax.scan program over n sweeps — a single XLA
                    # dispatch; metrics come back stacked [n]
                    state, mstack = batch_fn(state, key, s, n)
                    pick = lambda v, j: v[j]  # noqa: E731
                fetch_js = {
                    j for j in range(n)
                    if ((s + j + 1) % every == 0 or s + j == total - 1
                        or cfg.verbose or callback is not None
                        or log_f is not None or trace_this)}
                m_host = jax.device_get(mstack) if fetch_js else None
                if trace_this:
                    jax.profiler.stop_trace()
                dt = (time.perf_counter() - t0) / n
                for j in range(n):
                    i = s + j
                    metrics = ({k: float(pick(v, j))
                                for k, v in m_host.items()}
                               if j in fetch_js else {})
                    phase = "burnin" if i < cfg.burnin else "sample"
                    metrics["time"] = dt
                    history.append(metrics)
                    if log_f is not None:
                        import json
                        log_f.write(json.dumps(
                            {"sweep": i + 1, "phase": phase,
                             **metrics}) + "\n")
                        log_f.flush()
                    if cfg.output_prefix is not None and i >= cfg.burnin:
                        # chunks are size 1 in the psamples phase when
                        # output_prefix is set (_chunk_limit), so `state`
                        # here is sweep i's state
                        self._save_sample(cfg.output_prefix,
                                          i - cfg.burnin, state)
                    if (cfg.checkpoint_every and cfg.checkpoint_path
                            and (i + 1) % cfg.checkpoint_every == 0):
                        self.save_state(cfg.checkpoint_path, state, i + 1)
                    if callback is not None:
                        callback(i, phase, metrics, dt)
                    if cfg.verbose:
                        self._print_sweep(i, phase, metrics)
                s += n
        finally:
            if log_f is not None:
                log_f.close()
        return self._results(state, history)

    def benchmark(self, num_sweeps: int, repeats: int = 1,
                  key: Optional[jax.Array] = None) -> Dict[str, Any]:
        """Public timing entry point (bench.py uses ONLY this).

        Compiles the sweep program on an untimed leading window, then runs
        ``repeats`` timed windows of ``num_sweeps`` sweeps each —
        continuing one Gibbs chain, so every window does identical
        static-shaped work.  Ends each window with a real device->host
        transfer, so every window's time includes all of its device work.

        Returns::

            {"ms_per_sweep": [per-window mean, ...],   # len == repeats
             "metrics": {...final sweep's metrics...},
             "rmse_at_sweeps": rmse_sample at sweep `num_sweeps`}
        """
        cfg = self.config
        if key is None:
            key = jax.random.key(cfg.seed)
        state = self.init_state(jax.random.fold_in(key, 0))
        spd = max(getattr(cfg, "sweeps_per_dispatch", 1), 1)
        batch_fn = getattr(self, "_do_sweeps_batch", None)
        windows: List[float] = []
        rmse_at = None
        metrics = {}

        def run_window(state, start, n):
            t0 = time.perf_counter()
            if spd > 1 and batch_fn is not None:
                s = start
                while s < start + n:
                    c = min(spd, start + n - s)
                    state, mstack = batch_fn(state, key, s, c)
                    s += c
                mkey = next(k for k in mstack if k.endswith("rmse_avg"))
                last = {k: v[-1] for k, v in mstack.items()}
            else:
                for s in range(start, start + n):
                    state, last = self._do_sweep(
                        state, sweep_key(key, s + 1),
                        1.0 if s >= cfg.burnin else 0.0)
                mkey = next(k for k in last if k.endswith("rmse_avg"))
            _ = float(last[mkey])          # real D2H: end of window
            dt = time.perf_counter() - t0
            return state, {k: float(v) for k, v in
                           jax.device_get(last).items()}, dt

        # compile + warm window (untimed); its final rmse_sample is the
        # trajectory value at `num_sweeps` (the north-star "RMSE @ N")
        state, metrics, _ = run_window(state, 0, num_sweeps)
        rk = next((k for k in metrics if k.endswith("rmse_sample")), None)
        rmse_at = metrics.get(rk) if rk else None
        for r in range(repeats):
            state, metrics, dt = run_window(
                state, (r + 1) * num_sweeps, num_sweeps)
            windows.append(dt * 1e3 / num_sweeps)
        return {"ms_per_sweep": windows, "metrics": metrics,
                "rmse_at_sweeps": rmse_at}

    def _chunk_limit(self, s: int, total: int) -> int:
        """Exclusive upper bound for a scan chunk starting at sweep `s`:
        chunks must END at any sweep whose host work needs that sweep's
        on-host state (checkpoint save, posterior-sample dump, profiler
        trace)."""
        cfg = self.config
        end = total
        if cfg.trace_dir is not None:
            t = min(2, total - 1)
            if t > s:
                end = min(end, t)  # stop before the traced sweep
        ce = cfg.checkpoint_every
        if ce and cfg.checkpoint_path:
            nxt = s + ((ce - ((s + 1) % ce)) % ce)  # first i>=s, (i+1)%ce==0
            end = min(end, nxt + 1)
        if cfg.output_prefix is not None:
            # every sweep >= burnin dumps a posterior sample
            end = min(end, cfg.burnin if s < cfg.burnin else s + 1)
        return max(end, s + 1)

    def _print_sweep(self, s, phase, metrics):
        """Reference-style verbose line (SURVEY §4.6): sweep, phase,
        RMSE avg/sample, AUC, |U|, |beta|, alpha, lambda_beta, time."""
        parts = [f"sweep {s + 1:4d} [{phase:6s}]"]
        for ri, rs in enumerate(self.problem.rel_specs):
            k = f"r{ri}.rmse_avg"
            if k in metrics:
                line = (f"{rs.name}: RMSE={metrics[k]:.4f} "
                        f"(sample {metrics[f'r{ri}.rmse_sample']:.4f})")
                if f"r{ri}.auc" in metrics:
                    line += f" AUC={metrics[f'r{ri}.auc']:.4f}"
                parts.append(line)
            if f"r{ri}.alpha" in metrics:
                parts.append(f"a{ri}={metrics[f'r{ri}.alpha']:.2f}")
        for ei in range(len(self.problem.entity_specs)):
            if f"e{ei}.unorm" in metrics:
                parts.append(f"|U{ei}|={metrics[f'e{ei}.unorm']:.1f}")
            if f"e{ei}.betanorm" in metrics:
                parts.append(f"|b{ei}|={metrics[f'e{ei}.betanorm']:.2f}"
                             f" lb={metrics[f'e{ei}.lambda_beta']:.3f}")
            if f"e{ei}.cg_iters" in metrics:
                parts.append(f"cg{ei}={metrics[f'e{ei}.cg_iters']:.0f}")
        parts.append(f"{metrics['time']:.3f}s")
        print("  ".join(parts), flush=True)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class MacauEngine(GibbsDriverMixin):
    """Compiled Gibbs engine for one RelationData graph."""

    def __init__(self, rd: RelationData, config: MacauConfig):
        enable_compile_cache()
        self.rd = rd
        self.config = config
        self.problem = CompiledProblem(rd, config)
        self.dtype = jnp.dtype(config.dtype)
        self._sweep_jit = jax.jit(self._sweep_keyed, donate_argnums=(1,))
        self._sweep_randoms_jit = jax.jit(self._sweep_with_randoms,
                                          donate_argnums=(1,))
        self._batch_jits: Dict[int, Any] = {}  # chunk size -> scan jit

    # -- state ---------------------------------------------------------------
    def init_state(self, key: Optional[jax.Array] = None) -> Dict[str, Any]:
        """Init per SURVEY §4.6: U ~ init_std*N(0,I), mu=0, Lambda=I, beta=0."""
        cfg = self.config
        K = cfg.num_latent
        dtype = self.dtype
        if key is None:
            key = jax.random.key(cfg.seed)
        ents = []
        for ei, es in enumerate(self.problem.entity_specs):
            k = jax.random.fold_in(key, 1000 + ei)
            ent = {
                "U": cfg.init_std * jax.random.normal(k, (es.n, K), dtype),
                "mu": jnp.zeros((K,), dtype),
                "Lambda": jnp.eye(K, dtype=dtype),
            }
            if es.has_features:
                ent["beta"] = jnp.zeros((es.num_features, K), dtype)
                ent["uhat"] = jnp.zeros((es.n, K), dtype)
                ent["lambda_beta"] = jnp.asarray(
                    self.problem.init_lambda_beta[ei], dtype)
            ents.append(ent)
        rels = [{"alpha": jnp.asarray(self.problem.init_alpha[ri], dtype)}
                for ri in range(len(self.problem.rel_specs))]
        preds = {}
        for ri, rs in enumerate(self.problem.rel_specs):
            if rs.n_test:
                preds[f"r{ri}"] = {
                    "sum": jnp.zeros((rs.n_test,), dtype),
                    "sum2": jnp.zeros((rs.n_test,), dtype),
                    "n": jnp.zeros((), dtype)}
        return {"ent": ents, "rel": rels, "pred": preds}

    # -- one sweep (jitted) --------------------------------------------------
    def _sweep_keyed(self, arrays, state, key, accumulate):
        randoms = draw_all(key, self.problem.random_spec, self.dtype)
        return self._sweep_with_randoms(arrays, state, randoms, accumulate)

    def _sweep_with_randoms(self, arrays, state, randoms, accumulate):
        cfg = self.config
        K = cfg.num_latent
        dtype = self.dtype
        nu0 = cfg.resolved_nu0()
        specs = self.problem.entity_specs
        rel_specs = self.problem.rel_specs
        metrics: Dict[str, jax.Array] = {}

        ents = list(state["ent"])
        rels = list(state["rel"])

        # ---- sequential scan over entities (SURVEY §4.2 note) ----
        for ei, es in enumerate(specs):
            ent = dict(ents[ei])
            U = ent["U"]
            Lambda = ent["Lambda"]

            uhat = ent.get("uhat")
            if es.has_features:
                # β draw first, with current Λ (SURVEY §4.6 order)
                with jax.named_scope(f"beta_e{ei}"):
                    ent, cg_diag = self._sample_beta(arrays, ent, es, ei,
                                                     randoms)
                if cg_diag is not None:
                    metrics[f"e{ei}.cg_iters"] = cg_diag[0]
                    metrics[f"e{ei}.cg_resid"] = cg_diag[1]
                if cfg.sample_lambda_beta:
                    ent["lambda_beta"] = sample_lambda_beta(
                        ent["beta"], Lambda, randoms[f"e{ei}.lb_g"],
                        cfg.nu_beta, cfg.lambda_beta_mean)
                uhat = ent["uhat"]

            # Normal-Wishart on the residual (SURVEY §4.3)
            S = U - uhat if uhat is not None else U
            with jax.named_scope(f"nw_e{ei}"):
                mu, Lambda = normal_wishart_update(
                    S, cfg.nw_b0, nu0,
                    2.0 * randoms[f"e{ei}.nw_g"],
                    randoms[f"e{ei}.nw_tri"], randoms[f"e{ei}.nw_mu"])
            ent["mu"], ent["Lambda"] = mu, Lambda

            # batched latent-row conditional (SURVEY §4.2)
            prior_mean = jnp.broadcast_to(mu[None, :], (es.n, K))
            if uhat is not None:
                prior_mean = prior_mean + uhat
            contribs = []
            dense_contribs = []
            for ri, rs in enumerate(rel_specs):
                for mode in range(rs.arity):
                    if rs.entity_ids[mode] != ei:
                        continue
                    partners = [ents[rs.entity_ids[d]]["U"]
                                for d in range(rs.arity) if d != mode]
                    plan = self.problem.dense_plans.get((ri, mode))
                    if plan is not None:
                        dense_contribs.append(
                            (rels[ri]["alpha"], partners, ri, mode, plan))
                    # hybrid fused relations carry residual buckets
                    # alongside the dense plan (empty list otherwise)
                    for ba in arrays["layouts"][f"r{ri}m{mode}"]:
                        contribs.append((rels[ri]["alpha"], partners, ba))
            gd = jnp.dtype(cfg.gram_dtype) if cfg.gram_dtype else None
            if cfg.accumulation == "planned":
                P_acc, b_acc = assemble_precision_planned(
                    Lambda, prior_mean, contribs, es.n,
                    arrays["acc_plan"][f"e{ei}"], gram_dtype=gd)
            else:
                P_acc, b_acc = assemble_precision(
                    Lambda, prior_mean, contribs, es.n, gram_dtype=gd)
            # dense contributions (ops/dense_gram.py): one canonical-
            # tensor einsum per mode instead of the per-observation gather
            for alpha, partners, ri, mode, plan in dense_contribs:
                with jax.named_scope(f"dense_r{ri}m{mode}"):
                    mdt = gd if gd is not None else dtype
                    P_d, b_d = self._dense_mode_contrib(
                        arrays, ri, mode, plan, partners, dtype, mdt,
                        alpha=alpha)
                    P_acc = P_acc + P_d
                    b_acc = b_acc + b_d
            ent["U"] = chol_sample_dispatch(cfg, P_acc, b_acc,
                                            randoms[f"e{ei}.xi"])
            ents[ei] = ent
            metrics[f"e{ei}.unorm"] = jnp.linalg.norm(ent["U"])
            if es.has_features:
                metrics[f"e{ei}.betanorm"] = jnp.linalg.norm(ent["beta"])
                metrics[f"e{ei}.lambda_beta"] = ent["lambda_beta"]

        # ---- noise precisions (SURVEY §4.5) ----
        for ri, rs in enumerate(rel_specs):
            if not rs.alpha_sample:
                continue
            tr = arrays["train"][f"r{ri}"]
            factors = [ents[eid]["U"] for eid in rs.entity_ids]
            pred_c = predict_tuples(factors, tr["idx"],
                                    jnp.asarray(0.0, dtype))
            sse = jnp.sum((tr["vals"] - pred_c) ** 2)
            rels[ri] = {"alpha": sample_alpha(
                sse, rs.nnz, randoms[f"r{ri}.alpha_g"],
                cfg.alpha_a0, cfg.alpha_b0)}
            metrics[f"r{ri}.alpha"] = rels[ri]["alpha"]

        # ---- prediction + posterior accumulation (SURVEY §4.7) ----
        preds = dict(state["pred"])
        acc = jnp.asarray(accumulate, dtype)
        for ri, rs in enumerate(rel_specs):
            pk = f"r{ri}"
            if pk not in preds:
                continue
            te = arrays["test"][pk]
            factors = [ents[eid]["U"] for eid in rs.entity_ids]
            p = predict_tuples(factors, te["idx"],
                               jnp.asarray(rs.mean_value, dtype))
            if cfg.clamp is not None:
                p = jnp.clip(p, cfg.clamp[0], cfg.clamp[1])
            pr = dict(preds[pk])
            pr["sum"] = pr["sum"] + acc * p
            pr["sum2"] = pr["sum2"] + acc * p * p
            pr["n"] = pr["n"] + acc
            preds[pk] = pr
            metrics[f"{pk}.rmse_sample"] = jnp.sqrt(
                jnp.mean((p - te["vals"]) ** 2))
            n_eff = jnp.maximum(pr["n"], 1.0)
            pmean = pr["sum"] / n_eff
            metrics[f"{pk}.rmse_avg"] = jnp.sqrt(
                jnp.mean((pmean - te["vals"]) ** 2))
            if rs.class_cut is not None:
                # per-sweep AUC of the running posterior mean (reference
                # verbose field, SURVEY §4.6) — midrank statistic on
                # device, tie handling identical to the host _auc
                labels = (te["vals"] < rs.class_cut).astype(dtype)
                metrics[f"{pk}.auc"] = auc_device(labels, -pmean)

        new_state = {"ent": ents, "rel": rels, "pred": preds}
        return new_state, metrics

    def _dense_mode_contrib(self, arrays, ri, mode, plan, partners,
                            dtype, mdt, alpha=None):
        """One dense mode's (P, b): the M/W pair path (bf16 or s8) or the
        single-array fused path (ops/dense_gram.fused_gram_contrib) per
        the compile-time plan kind.  When ``alpha`` is given it is FOLDED
        into the contribution (dequant scales on the s8 paths) for every
        kind; the caller must not multiply again."""
        st = arrays["dense"][f"r{ri}"]
        if plan.kind == "fused":
            s, m = self.problem.fused_rels[ri]
            rs = self.problem.rel_specs[ri]
            if self.problem.fused_i8.get(ri):
                from ..ops.dense_gram import fused_gram_contrib_i8
                return fused_gram_contrib_i8(
                    st["V8"], partners[0], mode, dtype, s, m,
                    rs.mean_value, ridge_deg=st.get(f"deg_m{mode}"),
                    alpha=alpha)
            from ..ops.dense_gram import fused_gram_contrib
            P_f, b_f = fused_gram_contrib(
                st["V8"], partners[0], mode, dtype, mdt, s, m,
                rs.mean_value)
            if alpha is not None:
                P_f, b_f = alpha * P_f, alpha * b_f
            return P_f, b_f
        dims = list(plan.partner_counts)
        dims.insert(mode, plan.n_focus)
        return dense_gram_contrib(
            st["M"], st["W"], partners, mode, dims, dtype, mdt,
            w_scale=self.problem.dense_w_scale.get(ri),
            ridge_deg=st.get(f"deg_m{mode}"),
            alpha=alpha)

    def _sample_beta(self, arrays, ent, es: EntitySpec, ei: int, randoms):
        """Noise-injected exact Gibbs draw of beta (SURVEY §4.4)."""
        cfg = self.config
        dtype = self.dtype
        U, mu, Lambda = ent["U"], ent["mu"], ent["Lambda"]
        lam = ent["lambda_beta"]
        feat = arrays["feat"][f"e{ei}"]
        mv = feat["mv"]
        N, F = es.n, es.num_features

        # E rows ~ N(0, Lambda^{-1}):  e = L^{-T} z  (L = chol(Lambda))
        L = lxl.cholesky(Lambda)
        def colored(z):  # [n, K] @ -> rows with cov Lambda^{-1}
            return lxl.triangular_solve(L, z.T, left_side=True, lower=True,
                                        transpose_a=True).T
        E1 = colored(randoms[f"e{ei}.beta_e1"])
        E2 = colored(randoms[f"e{ei}.beta_e2"])

        Xd = feat.get("dense_X")
        if Xd is not None:
            # dense feature products (ops/dense_gram.py use_dense_feat):
            # bandwidth-bound streams instead of issue-bound gathers.
            # Full compute-dtype precision: the matvecs stream the stored
            # int8/f32 slab either way (the cast fuses into the dot), and
            # bf16 V operands are CATASTROPHIC for the beta draw — the
            # Woodbury final subtraction amplifies the ~4e-3 rounding to
            # ~1e-1 true relative residual (r2 session-4 measurement);
            # a reduced-precision default matmul (TF32 on the GPU) does
            # the same, hence Precision.HIGHEST.
            hi = (jax.lax.Precision.HIGHEST
                  if dtype == jnp.float32 else None)

            def spmm_fwd(V):
                return jnp.einsum("nf,fk->nk", Xd.astype(dtype), V,
                                  preferred_element_type=dtype,
                                  precision=hi)

            def spmm_t(V):
                return jnp.einsum("nf,nk->fk", Xd.astype(dtype), V,
                                  preferred_element_type=dtype,
                                  precision=hi)
        else:
            def spmm_fwd(V):
                return bucketed_spmm(mv["fwd"], N, V)

            def spmm_t(V):
                return bucketed_spmm(mv["t"], F, V)

        resid = U - mu[None, :] + E1
        Xt_resid = spmm_t(resid)
        rhs = Xt_resid + jnp.sqrt(lam) * E2

        cg_diag = None
        if es.use_ff:
            A = arrays["ftf"][f"e{ei}"] + lam * jnp.eye(F, dtype=dtype)
            Lf = lxl.cholesky(A)
            y = lxl.triangular_solve(Lf, rhs, left_side=True, lower=True)
            beta = lxl.triangular_solve(Lf, y, left_side=True, lower=True,
                                        transpose_a=True)
        elif es.solver == "dual":
            # Woodbury exact solve on the cached XX' eigendecomposition,
            # N-space refinement against the exact G, uhat = z for free
            # (ops/dual.py dual_solve_g) — no CG iterations at all
            from ..ops.dual import dual_solve_g
            beta, uhat_z = dual_solve_g(
                feat["dual_Q"], feat["dual_d"], feat["dual_G"], lam, rhs,
                spmm_fwd, spmm_t, cfg.dual_refine)
            out = dict(ent)
            out["beta"], out["uhat"] = beta, uhat_z
            return out, None
        else:
            def matvec(V):
                return spmm_t(spmm_fwd(V)) + lam * V
            # Jacobi preconditioner: diag(X'X + lam I) = sq col sums + lam.
            # f32's recursive residual stalls around ~1e-5 relative, so
            # floor the tolerance there to avoid burning maxiter; the
            # reported cg_resid is the exit-time TRUE residual.
            tol = cfg.cg_tol if self.dtype == jnp.float64 \
                else max(cfg.cg_tol, 1e-5)
            precond = None
            if "nys_U" in feat:
                from ..ops.precond import nystrom_apply
                Un, dn = feat["nys_U"], feat["nys_d"]
                precond = lambda r: nystrom_apply(Un, dn, lam, r)  # noqa: E731
            beta, it, resid = block_cg(matvec, rhs, ent["beta"],
                                       tol=tol, maxiter=cfg.cg_maxiter,
                                       precond_diag=feat["colcount"] + lam,
                                       precond=precond)
            cg_diag = (it, resid)

        uhat = spmm_fwd(beta)
        out = dict(ent)
        out["beta"], out["uhat"] = beta, uhat
        return out, cg_diag

    # -- driver hooks (GibbsDriverMixin) -------------------------------------
    def _do_sweep(self, state, skey, accumulate, **_lookahead):
        return self._sweep_jit(self.problem.arrays, state, skey, accumulate)

    def _do_sweeps_batch(self, state, base_key, start: int, n: int):
        """Run sweeps [start, start+n) as ONE lax.scan program (config
        sweeps_per_dispatch > 1): removes per-sweep dispatch latency;
        returns (state, metrics stacked along a leading [n] axis).  Same
        per-sweep keys/accumulate flags as the single-sweep path, so
        results are bit-identical."""
        fn = self._batch_jits.get(n)
        if fn is None:
            burnin = self.config.burnin

            def scan_fn(arrays, st, key, start):
                def body(st, s):
                    skey = sweep_key(key, s + 1)
                    acc = (s >= burnin).astype(self.dtype)
                    return self._sweep_keyed(arrays, st, skey, acc)
                return jax.lax.scan(body, st,
                                    start + jnp.arange(n, dtype=jnp.int32))

            fn = jax.jit(scan_fn, donate_argnums=(1,))
            self._batch_jits[n] = fn
        return fn(self.problem.arrays, state, base_key,
                  jnp.asarray(start, jnp.int32))

    def _save_sample(self, prefix: str, psample_idx: int, state) -> None:
        """Dump one posterior sample (U/mu/Lambda/beta/lambda_beta/alpha)
        for model reuse — the reference's save-during-psamples behavior
        (SURVEY §7.4) used for out-of-matrix prediction."""
        st = jax.device_get(state)
        out = {}
        for ei, ent in enumerate(st["ent"]):
            for k, v in ent.items():
                out[f"e{ei}.{k}"] = v
        for ri, rel in enumerate(st["rel"]):
            out[f"r{ri}.alpha"] = rel["alpha"]
        np.savez(f"{prefix}-sample{psample_idx:04d}.npz", **out)

    def _results(self, state, history) -> Dict[str, Any]:
        """Reference-style result dict (SURVEY §4.6 return contract)."""
        out: Dict[str, Any] = {"state": state, "history": history}
        state_np = jax.device_get(state)
        for ri, rs in enumerate(self.problem.rel_specs):
            pk = f"r{ri}"
            if pk not in state_np["pred"]:
                continue
            pr = state_np["pred"][pk]
            n = max(float(pr["n"]), 1.0)
            pmean = pr["sum"] / n
            pvar = np.maximum(pr["sum2"] / n - pmean ** 2, 0.0)
            te_idx = np.asarray(self.problem.arrays["test"][pk]["idx"])
            te_val = np.asarray(self.problem.arrays["test"][pk]["vals"])
            rmse = float(np.sqrt(np.mean((pmean - te_val) ** 2)))
            rel_out = {
                "RMSE": rmse,
                "predictions": {
                    "idx": te_idx, "obs": te_val,
                    "pred": pmean, "stdev": np.sqrt(pvar)},
            }
            if rs.class_cut is not None:
                obs_cls = te_val < rs.class_cut
                rel_out["AUC"] = _auc(obs_cls, -pmean)
                rel_out["accuracy"] = float(
                    np.mean((pmean < rs.class_cut) == obs_cls))
            out[rs.name] = rel_out
            if ri == 0:
                out.update({k: v for k, v in rel_out.items()
                            if k != "predictions"})
                out["predictions"] = rel_out["predictions"]
        return out

    # -- checkpoint/resume (SURVEY §7.4) ------------------------------------
    def save_state(self, path: str, state, sweep: int) -> None:
        flat, treedef = jax.tree_util.tree_flatten(jax.device_get(state))
        np.savez(path, sweep=sweep, n_leaves=len(flat),
                 **{f"leaf{i}": a for i, a in enumerate(flat)})

    def load_state(self, path: str):
        z = np.load(path)
        template = self.init_state()
        flat, treedef = jax.tree_util.tree_flatten(template)
        leaves = [jnp.asarray(z[f"leaf{i}"]) for i in range(len(flat))]
        return (jax.tree_util.tree_unflatten(treedef, leaves),
                int(z["sweep"]))


def predictions_frame(result: Dict[str, Any], relation=None):
    """Reference-style predictions table (the Julia package returns a
    DataFrame with index columns + obs/pred/stdev; SURVEY §4.6).

    ``result`` is macau()'s return value; ``relation`` picks a named
    relation's sub-dict (default: top-level = first relation).
    """
    import pandas as pd
    src = result[relation] if relation is not None else result
    p = src["predictions"]
    d = {f"idx{d_}": p["idx"][:, d_] for d_ in range(p["idx"].shape[1])}
    d.update(obs=p["obs"], pred=p["pred"], stdev=p["stdev"])
    return pd.DataFrame(d)


def auc_device(labels: jax.Array, scores: jax.Array,
               weights: Optional[jax.Array] = None) -> jax.Array:
    """Binary AUC via the midrank statistic, jit-safe on device.

    Uses midranks for tied scores so it agrees with the host
    :func:`_auc` on ties — class_cut workloads routinely produce tied
    predictions.  Midranks are computed IN SORTED ORDER via tie-group
    boundary scans (cummax/cummin): labels (and weights) are co-sorted
    with the scores in one multi-operand ``lax.sort``, so no rank ever
    has to be scattered back.  The earlier two-sided ``searchsorted``
    formulation compiled to two 15-step binary-search while loops of
    30k dynamic gathers each at the ChEMBL test-set size.

    ``weights`` (0/1) excludes padding entries: padded rows must carry
    scores ABOVE every real score (e.g. +inf) so the real midranks are
    unaffected, and weight 0 so they contribute to no count.
    """
    dtype = scores.dtype
    n = scores.shape[0]
    ops = [scores, labels.astype(dtype)]
    if weights is not None:
        ops.append(weights.astype(dtype))
    srt = jax.lax.sort(ops, num_keys=1)
    s = srt[0]
    idx = jnp.arange(1, n + 1, dtype=jnp.int32)     # 1-based sorted ranks
    brk = s[1:] != s[:-1]                           # tie-group boundaries
    one = jnp.ones((1,), bool)
    # first/last 1-based index of each element's tie group
    start = jax.lax.cummax(jnp.where(jnp.concatenate([one, brk]), idx, 0))
    end = jax.lax.cummin(
        jnp.where(jnp.concatenate([brk, one]), idx, n + 1), reverse=True)
    ranks = 0.5 * (start + end).astype(dtype)       # 1-based midranks
    if weights is None:
        n_pos = jnp.sum(labels)
        n_neg = labels.shape[0] - n_pos
        r_pos = jnp.sum(ranks * srt[1])
    else:
        n_pos = jnp.sum(labels * weights)
        n_neg = jnp.sum(weights) - n_pos
        r_pos = jnp.sum(ranks * srt[1] * srt[2])
    return ((r_pos - n_pos * (n_pos + 1) / 2.0)
            / jnp.maximum(n_pos * n_neg, 1.0))


def _auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary AUC via the rank statistic."""
    pos = scores[labels]
    neg = scores[~labels]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]), kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # midranks for ties
    allv = np.concatenate([pos, neg])
    sv = allv[order]
    i = 0
    while i < len(sv):
        j = i
        while j + 1 < len(sv) and sv[j + 1] == sv[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    r_pos = ranks[:len(pos)].sum()
    n_p, n_n = len(pos), len(neg)
    return float((r_pos - n_p * (n_p + 1) / 2.0) / (n_p * n_n))


def predict_out_of_matrix(prefix: str, x_new, feat_entity: int = 0,
                          partner_entity: int = 1,
                          relation_mean: float = 0.0,
                          partner_rows: Optional[np.ndarray] = None
                          ) -> np.ndarray:
    """Predict for NEW instances from saved posterior samples.

    Mirrors the reference README workflow (SURVEY §7.4): reuse the saved
    link matrix / hyperparameters to score compounds never seen in
    training:  u_new = mu_e + beta_e' x_new;  pred = mean_r + u_new . v_j,
    averaged over the saved psamples.

    ``prefix`` is the ``output_prefix`` used during sampling; ``x_new`` is
    [n_new, F] (dense or anything np.asarray handles).
    """
    import glob as _glob
    files = sorted(_glob.glob(f"{prefix}-sample*.npz"))
    if not files:
        raise FileNotFoundError(f"no saved samples at {prefix}-sample*.npz")
    x_new = np.asarray(x_new, np.float64)
    acc = None
    for fn in files:
        z = np.load(fn)
        beta = z[f"e{feat_entity}.beta"]
        mu = z[f"e{feat_entity}.mu"]
        V = z[f"e{partner_entity}.U"]
        if partner_rows is not None:
            V = V[np.asarray(partner_rows)]
        u_new = mu[None, :] + x_new @ beta
        p = relation_mean + u_new @ V.T
        acc = p if acc is None else acc + p
    return acc / len(files)


# ---------------------------------------------------------------------------
# Public entry point — mirrors macau(rd; kwargs...) [HIGH]
# ---------------------------------------------------------------------------

def macau(data: RelationData,
          num_latent: int = 10,
          burnin: int = 500,
          psamples: int = 200,
          clamp: Optional[Sequence[float]] = None,
          verbose: bool = True,
          seed: int = 1234,
          config: Optional[MacauConfig] = None,
          **kwargs) -> Dict[str, Any]:
    """Bayesian factorization of a RelationData graph via Gibbs sampling.

    Reference entry point: ``macau(rd; num_latent=10, burnin=500,
    psamples=200, clamp, verbose, ...)`` — src/macau.jl [HIGH], SURVEY §4.6.
    Extra kwargs are forwarded into MacauConfig.
    """
    if config is None:
        config = MacauConfig(
            num_latent=num_latent, burnin=burnin, psamples=psamples,
            clamp=tuple(clamp) if clamp is not None else None,
            verbose=verbose, seed=seed, **kwargs)
    engine = MacauEngine(data, config)
    return engine.run()
