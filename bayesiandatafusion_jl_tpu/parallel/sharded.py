"""Multi-device Gibbs engine: hash-partitioned entities under shard_map.

This is the accelerator-native replacement for the reference's entire
distributed story (``ParallelSBM`` worker matvecs + one-node parallel row
sampling — SURVEY.md §3/§7.7/§7.8), designed per the north star
(BASELINE.json):

  - every entity's instances are **hash-partitioned** across the 1-D device
    mesh (a device-count-independent permutation, parallel/mesh.py), so
    per-shard nnz is balanced in expectation and factor state is
    comparable across topologies;
  - each device assembles Gramians and samples ONLY its instance shard
    (bucketed layouts are built per shard at compile time);
  - freshly sampled factor shards are exchanged by **all_gather** over the
    mesh axis, so the next entity's Gramian gathers read a replicated
    factor matrix (an all-gather of a few MB);
  - the blocked-CG beta solve runs the matvec on the row-sharded feature
    matrix and **psum**s the X'(Xv) reduction — the ParallelSBM
    equivalent;
  - Normal-Wishart / lambda_beta / alpha conditionals reduce sufficient
    statistics with psum and then every device makes the identical
    replicated draw from the shared randoms pytree.

Randoms are drawn in ORIGINAL instance order with the same spec as the
single-device engine and permuted into the shard layout, so a sharded run
reproduces the single-device run to float tolerance (reduction order is
the only difference) — the determinism-under-resharding test of SURVEY
§7.2 relies on this.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.lax import linalg as lxl
from jax.sharding import Mesh, PartitionSpec as P

from ..models.data import (RelationData, resolved_alpha,
                           resolved_alpha_sample, resolved_lambda_beta)
from ..models.engine import (EntitySpec, GibbsDriverMixin, RelationSpec,
                             _auc, build_random_spec)
from ..ops import layout as layout_mod
from ..ops.cg import block_cg
from ..ops.dense_gram import dense_gram_contrib
from ..ops.gramian import (assemble_precision,
                           assemble_precision_planned,
                           predict_tuples)
from ..ops.hyper import (normal_wishart_from_moments, sample_alpha,
                         sample_lambda_beta)
from ..ops.mvn import chol_sample_dispatch
from ..utils.compile_cache import enable_compile_cache
from ..utils.config import MacauConfig
from ..utils.rng import draw_all, sweep_key
from .mesh import AXIS, data_mesh, instance_permutation


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_head_split(cfg_value, deg: np.ndarray, n_dev: int):
    """Head-split threshold for one entity (SURVEY §7.7).

    ``None`` = off, an int = explicit threshold (both as before).
    ``"auto"`` (the default since r3 — VERDICT r2 weak #4: the machinery
    shipped with no perf-based default) engages exactly when one
    instance's GATHER-PATH degree exceeds a quarter of a device's average
    gather work — below that the hash partition already balances, and
    ghost slots would only add a psum.  Returns the threshold or None.
    """
    if cfg_value is None or isinstance(cfg_value, (int, np.integer)):
        return cfg_value
    if cfg_value != "auto":
        raise ValueError(f"head_split_degree={cfg_value!r}")
    if n_dev <= 1 or deg.size == 0:
        return None
    total = float(deg.sum())
    if total == 0.0:
        return None
    thr = max(2048.0, 0.25 * total / n_dev)
    return int(thr) if float(deg.max()) > thr else None


def resolve_exchange_blocks(cfg_value, n_dev: int, min_n_loc: int) -> int:
    """Block-pipelined exchange depth (SURVEY §7.7).

    ``None`` = auto: 4 blocks when there is a real all-gather to overlap
    (n_dev > 1) and every shard is large enough that quartering it keeps
    the chunked kernels efficient; otherwise 1 (also the mesh=1 answer —
    splitting the sample dispatch buys nothing without an exchange)."""
    if cfg_value is not None:
        return max(1, int(cfg_value))
    return 4 if (n_dev > 1 and min_n_loc >= 4096) else 1


@dataclasses.dataclass(frozen=True)
class ShardedEntityMeta:
    n: int          # real instance count
    n_pad: int      # padded to a multiple of n_dev
    n_loc: int      # per-device shard size
    n_head: int = 0  # head instances split across devices (ghost slots)

    @property
    def n_ext(self) -> int:
        return self.n_loc + self.n_head


class ShardedProblem:
    """Per-device bucketed layouts + sharded feature/test/train arrays."""

    def __init__(self, rd: RelationData, config: MacauConfig, n_dev: int):
        self.config = config
        self.n_dev = n_dev
        dtype = config.np_dtype()

        ent_index = {id(e): i for i, e in enumerate(rd.entities)}
        self.entity_specs: List[EntitySpec] = []
        self.rel_specs: List[RelationSpec] = []
        self.ent_meta: List[ShardedEntityMeta] = []
        self.perms: List[np.ndarray] = []      # position -> original id
        pos_of: List[np.ndarray] = []          # original id -> position

        # dense Gramian plan (ops/dense_gram.py), focus-sharded: each
        # dense mode stores its own [n_dev, n_loc, prod(partner n_pad)]
        # M/W slab pair (per-mode pairs: mode shardings differ, so the
        # single-device canonical-array sharing does not apply).  Head
        # splitting is unnecessary for dense modes — matmul work is balanced
        # by row count, not degree — so head observations stay with their
        # owner's M rows.  Planned FIRST so the auto head-split threshold
        # can count gather-path degrees only.
        from ..ops import dense_gram as dg
        store_np = (np.float32 if config.gram_dtype == "bfloat16"
                    else config.np_dtype())
        store_jnp = (jnp.bfloat16 if config.gram_dtype == "bfloat16"
                     else jnp.dtype(config.dtype))
        self.dense_w_scale: Dict[Tuple[int, int], float] = {}
        # layout-invariant int8 eligibility — must match the single-device
        # engine's decision (same helper, original idx + true counts)
        i8_ok = [config.dense_int8
                 and dg.int8_pair_ok(rel.data.idx,
                                     [e.count for e in rel.entities])
                 for rel in rd.relations]
        base_item = jnp.dtype(store_jnp).itemsize
        pair_item = [1 if ok else base_item for ok in i8_ok]
        shapes = [tuple(e.count for e in rel.entities)
                  for rel in rd.relations]
        # single-array fused path: the encoding + engagement arguments are
        # IDENTICAL to the single-device engine's (original idx/vals, true
        # counts, same budget) so both engines always pick the same set
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
        self.fused_i8: Dict[int, bool] = {}
        self.fused_keep: Dict[int, np.ndarray] = {}
        self.fused_rels, fused_spent = dg.plan_fused_rels(
            shapes, [rel.data.nnz for rel in rd.relations],
            config.num_latent, config.dense_gram, config.dense_fused,
            fused_enc, pair_item, config.dense_gram_budget_gb * 1e9)
        self.dense_plans, _, _ = dg.plan_dense_modes(
            shapes,
            [0 if ri in self.fused_rels else rel.data.nnz
             for ri, rel in enumerate(rd.relations)], config.num_latent,
            config.dense_gram,
            config.dense_gram_budget_gb * 1e9 - fused_spent,
            pair_item, per_mode_pairs=True)

        # per-entity GATHER-PATH degree, for head splitting: dense/fused
        # modes never head-split (their matmul work is row-balanced)
        deg_tot = [np.zeros(e.count, np.int64) for e in rd.entities]
        for ri, rel in enumerate(rd.relations):
            for d, e in enumerate(rel.entities):
                if (ri, d) in self.dense_plans or ri in self.fused_rels:
                    continue
                deg_tot[ent_index[id(e)]] += np.bincount(
                    rel.data.idx[:, d], minlength=e.count)

        self.head_pos: List[np.ndarray] = []   # permuted POSITIONS of heads
        self.head_rank: List[Dict[int, int]] = []
        for ei, ent in enumerate(rd.entities):
            n = ent.count
            perm = instance_permutation(n, ei)
            inv = np.empty(n, np.int64)
            inv[perm] = np.arange(n)
            n_pad = _ceil_to(n, n_dev)
            self.perms.append(perm)
            pos_of.append(inv)
            thr = resolve_head_split(config.head_split_degree,
                                     deg_tot[ei], n_dev)
            if thr is not None:
                head_ids = np.nonzero(deg_tot[ei] > thr)[0]
            else:
                head_ids = np.zeros(0, np.int64)
            hpos = np.sort(inv[head_ids]) if len(head_ids) else head_ids
            n_head = _ceil_to(len(hpos), 8) if len(hpos) else 0
            self.head_pos.append(hpos)
            self.head_rank.append({int(p): r for r, p in enumerate(hpos)})
            self.ent_meta.append(ShardedEntityMeta(
                n, n_pad, n_pad // n_dev, n_head))
        self.exchange_blocks = resolve_exchange_blocks(
            config.exchange_blocks, n_dev,
            min(m.n_loc for m in self.ent_meta) if self.ent_meta else 0)

        arrays_sh: Dict[str, Any] = {"layouts": {}, "feat": {}, "test": {},
                                     "train": {}, "rowmask": {},
                                     "acc_plan": {}, "headmap": {},
                                     "dense": {}}
        arrays_rep: Dict[str, Any] = {"ftf": {}, "nys": {}}
        self.test_meta: Dict[int, Dict[str, Any]] = {}
        host_inst: Dict[str, List[List[np.ndarray]]] = {}  # key -> [dev][bucket]

        for ri, rel in enumerate(rd.relations):
            mean_value = float(rel.data.vals.mean()) if rel.data.nnz else 0.0
            eids = tuple(ent_index[id(e)] for e in rel.entities)
            self.rel_specs.append(RelationSpec(
                name=rel.name, arity=rel.arity, entity_ids=eids,
                nnz=rel.data.nnz, n_test=len(rel.test_vals),
                alpha_sample=resolved_alpha_sample(rel, config),
                mean_value=mean_value,
                class_cut=rel.class_cut))
            # remap observation indices into permuted positions
            idx_p = np.stack([pos_of[eids[d]][rel.data.idx[:, d]]
                              for d in range(rel.arity)], axis=1)
            centered = rel.data.vals - mean_value
            if ri in self.fused_rels:
                # ONE row-sharded int8 value array serves both modes:
                # mode 0 contracts its local slab (focus rows, no comm);
                # mode 1 contracts the SHARDED axis and psum_scatters the
                # partials straight into each device's focus slice.
                # Stored in the permuted+padded layout; pad cells are 0 =
                # unobserved, so they contribute nothing through the mask.
                s_, m_ = self.fused_rels[ri]
                kp = fused_keep_all[ri]
                if not kp.all():
                    self.fused_keep[ri] = kp
                idx_k = idx_p if kp.all() else idx_p[kp]
                vals_k = rel.data.vals if kp.all() else rel.data.vals[kp]
                dims_pad = [self.ent_meta[eids[d]].n_pad
                            for d in range(rel.arity)]
                meta0 = self.ent_meta[eids[0]]
                if idx_k.shape[0] > 5_000_000:
                    # netflix-scale: build V8 ON DEVICE from the COO
                    # (~0.9 GB shipped instead of the 8.6 GB dense array)
                    Vd = dg.build_fused_values_device(
                        idx_k, vals_k, (dims_pad[0], dims_pad[1]),
                        s_, m_)
                    # DONATED reshape: a plain .reshape to the leading
                    # device axis may materialize an 8.6 GB copy next to
                    # the live 2-D buffer; donation aliases it
                    resh = jax.jit(
                        lambda v: v.reshape(n_dev, meta0.n_loc,
                                            dims_pad[1]),
                        donate_argnums=0)
                    arrays_sh["dense"][f"r{ri}"] = {"V8": resh(Vd)}
                    del Vd
                else:
                    e8 = dg.encode_fused_values(vals_k, s_, m_)
                    lin_p = (idx_k[:, 0].astype(np.int64) * dims_pad[1]
                             + idx_k[:, 1])
                    V = np.zeros(dims_pad[0] * dims_pad[1], np.int8)
                    V[lin_p] = e8
                    arrays_sh["dense"][f"r{ri}"] = {"V8": jnp.asarray(
                        V.reshape(n_dev, meta0.n_loc, dims_pad[1]))}
                    del V
                # fused s8 variant: the SAME layout-invariant decision
                # as the single-device engine (engine-parity invariant)
                self.fused_i8[ri] = bool(
                    config.dense_int8
                    and dg.fused_int8_ok(
                        dg.fused_code_bound(vals_k, s_, m_),
                        [e.count for e in rel.entities], idx=idx_k,
                        abs_codes=dg.fused_abs_codes(vals_k, s_, m_)))
                if self.fused_i8[ri]:
                    # static focus observation counts (int8 PD ridge) in
                    # the permuted+padded shard layout: mode 0 tiles by
                    # the row shard, mode 1 by the psum_scatter tile
                    # (fused-path observations only, like the plain engine)
                    for mode in range(rel.arity):
                        deg = np.bincount(idx_k[:, mode],
                                          minlength=dims_pad[mode])
                        arrays_sh["dense"][f"r{ri}"][f"deg_m{mode}"] = \
                            jnp.asarray(deg.reshape(n_dev, -1), jnp.float32)
                for mode in range(rel.arity):
                    self.dense_plans[(ri, mode)] = dg.DenseModePlan(
                        "fused", dims_pad[mode],
                        (dims_pad[1 - mode],))
                    if kp.all():
                        arrays_sh["layouts"][f"r{ri}m{mode}"] = []
                        host_inst[f"r{ri}m{mode}"] = [[]
                                                      for _ in range(n_dev)]
            # hybrid fused relations: residual observations (duplicates /
            # zero-code level, exact values) get the normal sharded
            # bucketed layouts, built from the residual subset below
            resid_sel = (np.nonzero(~self.fused_keep[ri])[0]
                         if ri in self.fused_keep else None)
            for mode in range(rel.arity):
                em = eids[mode]
                meta = self.ent_meta[em]
                if ri in self.fused_rels and resid_sel is None:
                    continue
                if ri not in self.fused_rels and (ri, mode) in self.dense_plans:
                    # full permuted+padded pair [n_pad, prod partner n_pad];
                    # reshape to [n_dev, n_loc, Np] IS the per-device stack
                    # (owner = position // n_loc)
                    perm_order = [mode] + [d for d in range(rel.arity)
                                           if d != mode]
                    dims = [self.ent_meta[eids[d]].n_pad
                            for d in range(rel.arity)]
                    M, W = dg.build_dense_pair(idx_p, centered, dims,
                                               store_np, perm=perm_order)
                    q8 = dg.quantize_dense_pair(M, W) if i8_ok[ri] else None
                    if q8 is not None:
                        M, W, self.dense_w_scale[(ri, mode)] = q8
                        store = jnp.int8
                    else:
                        store = store_jnp
                    arrays_sh["dense"][f"r{ri}m{mode}"] = {
                        "M": jnp.asarray(
                            M.reshape(n_dev, meta.n_loc, -1), store),
                        "W": jnp.asarray(
                            W.reshape(n_dev, meta.n_loc, -1), store)}
                    if q8 is not None:
                        # static focus-row observation counts (int8 PD
                        # ridge), in the permuted+padded shard layout
                        deg = np.bincount(idx_p[:, mode],
                                          minlength=meta.n_pad)
                        arrays_sh["dense"][f"r{ri}m{mode}"]["deg"] = \
                            jnp.asarray(deg.reshape(n_dev, meta.n_loc),
                                        jnp.float32)
                    del M, W
                    arrays_sh["layouts"][f"r{ri}m{mode}"] = []
                    host_inst[f"r{ri}m{mode}"] = [[] for _ in range(n_dev)]
                    continue
                g_idx = idx_p if resid_sel is None else idx_p[resid_sel]
                g_cen = (centered if resid_sel is None
                         else centered[resid_sel])
                owner = g_idx[:, mode] // meta.n_loc
                local_focus = g_idx[:, mode] - owner * meta.n_loc
                if meta.n_head:
                    # head observations round-robin across devices; they
                    # accumulate into per-device GHOST slots psum-reduced
                    # at sample time (SURVEY §7.7 head splitting)
                    rank_map = self.head_rank[em]
                    is_head = np.isin(g_idx[:, mode], self.head_pos[em])
                    hsel = np.nonzero(is_head)[0]
                    owner[hsel] = hsel % n_dev
                    local_focus[hsel] = meta.n_loc + np.asarray(
                        [rank_map[int(p)] for p in g_idx[hsel, mode]],
                        np.int64)
                per_dev = []
                for d in range(n_dev):
                    sel = owner == d
                    loc_idx = g_idx[sel].copy()
                    loc_idx[:, mode] = local_focus[sel]
                    per_dev.append(layout_mod.build_mode_layout(
                        loc_idx, g_cen[sel], mode, meta.n_ext,
                        widths=config.bucket_widths, row_pad=config.row_pad,
                        dtype=dtype))
                stacked, dev_inst = self._stack_layouts(per_dev, rel.arity,
                                                        dtype)
                arrays_sh["layouts"][f"r{ri}m{mode}"] = stacked
                host_inst[f"r{ri}m{mode}"] = dev_inst

            if rel.test_idx.shape[0]:
                t_idx = np.stack([pos_of[eids[d]][rel.test_idx[:, d]]
                                  for d in range(rel.arity)], axis=1)
                arrays_sh["test"][f"r{ri}"], counts = self._shard_tuples(
                    t_idx, rel.test_vals.astype(dtype), dtype)
                self.test_meta[ri] = {
                    "orig_idx": rel.test_idx.copy(),
                    "vals": rel.test_vals.copy(),
                    "counts": counts}
            if resolved_alpha_sample(rel, config):
                arrays_sh["train"][f"r{ri}"], _ = self._shard_tuples(
                    idx_p, centered.astype(dtype), dtype)

        for ei, ent in enumerate(rd.entities):
            meta = self.ent_meta[ei]
            nf = ent.num_features
            use_ff = False
            solver = "cg"
            if nf:
                pref = ent.use_ff if ent.use_ff is not None else config.use_ff
                use_ff = (nf <= config.ff_threshold) if pref is None \
                    else bool(pref)
                F = ent.F
                rows_p = pos_of[ei][F.rows]       # permuted positions
                owner = rows_p // meta.n_loc
                fvals = F.values()
                # per-device bucketed matvec layouts (ops/spmv.py), then
                # unified/stacked like the Gramian layouts
                from ..ops.spmv import build_bucketed_matvec
                per_dev_mv = []
                for d in range(n_dev):
                    sel = owner == d
                    per_dev_mv.append(build_bucketed_matvec(
                        (rows_p[sel] - d * meta.n_loc).astype(np.int32),
                        F.cols[sel], (meta.n_loc, nf),
                        vals=(None if F.is_binary else fvals[sel]),
                        widths=config.bucket_widths,
                        row_pad=config.row_pad, dtype=dtype))
                arrays_sh["feat"][f"e{ei}"] = {
                    key: self._stack_matvec([mv[key] for mv in per_dev_mv])
                    for key in ("fwd", "t")}
                arrays_sh["feat"][f"e{ei}"]["colcount"] = jnp.asarray(
                    np.broadcast_to(F.col_sq_sums().astype(dtype),
                                    (n_dev, nf)).copy())
                # dense row-sharded feature slab (ops/dense_gram.py
                # use_dense_feat): X'(Xv) becomes two bandwidth-bound
                # matmuls with a psum, replacing the issue-bound gathers
                fx_jnp = (store_jnp if F.is_binary else jnp.dtype(dtype))
                if F.is_binary and store_jnp == jnp.bfloat16:
                    # exact 0/1 in int8: halves the per-iteration HBM
                    # stream of the CG matvec (see models/engine.py)
                    fx_jnp = jnp.int8
                if dg.use_dense_feat(ent.count, nf, F.nnz,
                                     jnp.dtype(fx_jnp).itemsize,
                                     config.dense_gram):
                    Xd = np.zeros((meta.n_pad, nf),
                                  np.float32 if fx_jnp == jnp.bfloat16
                                  else dtype)
                    np.add.at(Xd, (rows_p, F.cols), fvals)
                    arrays_sh["feat"][f"e{ei}"]["dense_X"] = jnp.asarray(
                        Xd.reshape(n_dev, meta.n_loc, nf), fx_jnp)
                    del Xd
                from ..ops import dual as dual_mod
                solver = "ff" if use_ff else "cg"
                if not use_ff and dual_mod.use_dual(
                        config.beta_solver, ent.count, nf,
                        dtype.itemsize, config.dual_budget_gb):
                    # Woodbury exact solver: Q row-sharded by instance
                    # owner (same permutation as U), d replicated.  The
                    # eigendecomposition is over the ORIGINAL-order G so
                    # single-device and sharded runs share one eigenbasis
                    # (parity at 1e-8).
                    solver = "dual"
                    Qd, dd, G = dual_mod.dual_eig_cached(
                        F.rows, F.cols, fvals, F.shape, dtype,
                        config.dual_cache_dir)
                    Qp = np.zeros((meta.n_pad, meta.n), Qd.dtype)
                    Qp[:meta.n] = Qd[self.perms[ei]]
                    arrays_sh["feat"][f"e{ei}"]["dual_Q"] = jnp.asarray(
                        Qp.reshape(n_dev, meta.n_loc, meta.n))
                    arrays_sh["feat"][f"e{ei}"]["dual_d"] = jnp.asarray(
                        np.broadcast_to(dd, (n_dev, meta.n)).copy())
                    # exact G for the N-space refinement, permuted on
                    # BOTH axes to the owner layout so Gloc contracts the
                    # all-gathered z directly (pad rows/cols zero)
                    perm = self.perms[ei]
                    Gp = np.zeros((meta.n_pad, meta.n_pad), dtype)
                    Gp[:meta.n, :meta.n] = G[np.ix_(perm, perm)]
                    arrays_sh["feat"][f"e{ei}"]["dual_G"] = jnp.asarray(
                        Gp.reshape(n_dev, meta.n_loc, meta.n_pad))
                    del G, Qd, Qp, Gp
                from ..ops.precond import resolve_nystrom_rank
                nys_rank = resolve_nystrom_rank(config.cg_nystrom_rank, nf)
                if solver == "cg" and nys_rank and nf >= 4 * nys_rank:
                    # replicated Nystrom preconditioner (ops/precond.py):
                    # X'X is a global (psum-reduced) operator, so the
                    # factorization is device-independent and rides the
                    # P() replicated specs like ftf
                    from ..ops.precond import build_nystrom
                    Un, dn = build_nystrom(
                        F.rows, F.cols, F.values(), F.shape,
                        nys_rank, seed=config.seed)
                    arrays_rep["nys"][f"e{ei}"] = {
                        "U": jnp.asarray(Un, dtype),
                        "d": jnp.asarray(dn, dtype)}
                if use_ff:
                    import scipy.sparse as sp
                    X = sp.coo_matrix(
                        (fvals.astype(dtype), (F.rows, F.cols)),
                        shape=F.shape).tocsr()
                    arrays_rep["ftf"][f"e{ei}"] = jnp.asarray(
                        np.asarray((X.T @ X).todense(), dtype))
            self.entity_specs.append(EntitySpec(
                name=ent.name, n=ent.count, num_features=nf,
                use_ff=use_ff, feat_nnz=(ent.F.nnz if nf else 0),
                solver=(solver if nf else "cg")))
            rm = np.zeros((n_dev, meta.n_loc), dtype)
            rm.reshape(-1)[:meta.n] = 1.0
            arrays_sh["rowmask"][f"e{ei}"] = jnp.asarray(rm)
            if meta.n_head:
                # ghost-slot merge map: owner device + owner-local slot
                slot = np.zeros((n_dev, meta.n_head), np.int32)
                own = np.zeros((n_dev, meta.n_head), dtype)
                for r, pos in enumerate(self.head_pos[ei]):
                    d0 = int(pos) // meta.n_loc
                    slot[d0, r] = int(pos) - d0 * meta.n_loc
                    own[d0, r] = 1.0
                arrays_sh["headmap"][f"e{ei}"] = {
                    "slot": jnp.asarray(slot), "own": jnp.asarray(own)}

        # per-device accumulation plans (static gather + overflow), stacked
        from ..ops.gramian import plan_accumulation
        for ei in range(len(rd.entities)):
            meta = self.ent_meta[ei]
            plans = []
            for d in range(n_dev):
                inst_list = []
                for ri, rs in enumerate(self.rel_specs):
                    for mode in range(rs.arity):
                        if rs.entity_ids[mode] != ei:
                            continue
                        inst_list.extend(host_inst[f"r{ri}m{mode}"][d])
                plans.append(plan_accumulation(inst_list, meta.n_ext))
            rmax = max(len(p["ov_rows"]) for p in plans)
            first = np.stack([p["first"] for p in plans])
            has = np.stack([p["has"] for p in plans])
            ov_rows = np.zeros((n_dev, rmax), np.int32)
            ov_inst = np.full((n_dev, rmax), meta.n_ext, np.int32)
            for d, p in enumerate(plans):
                ov_rows[d, :len(p["ov_rows"])] = p["ov_rows"]
                ov_inst[d, :len(p["ov_inst"])] = p["ov_inst"]
            arrays_sh["acc_plan"][f"e{ei}"] = {
                "first": jnp.asarray(first), "has": jnp.asarray(has),
                "ov_rows": jnp.asarray(ov_rows),
                "ov_inst": jnp.asarray(ov_inst)}

        self.arrays_sh = arrays_sh
        self.arrays_rep = arrays_rep
        self.init_lambda_beta = [resolved_lambda_beta(e, config)
                                 for e in rd.entities]
        self.init_alpha = [resolved_alpha(r, config) for r in rd.relations]
        self.random_spec = build_random_spec(self.entity_specs,
                                             self.rel_specs, config)

    def _stack_layouts(self, per_dev, arity, dtype):
        """Unify bucket widths across devices, pad rows, stack on axis 0.

        Returns (stacked buckets, per-device inst arrays in bucket order)
        — the latter feeds the per-device accumulation plans.
        """
        n_dev = len(per_dev)
        widths = sorted({b.width for ml in per_dev for b in ml.buckets})
        out = []
        dev_inst: List[List[np.ndarray]] = [[] for _ in range(n_dev)]
        for w in widths:
            per = [next((b for b in ml.buckets if b.width == w), None)
                   for ml in per_dev]
            rows = max(b.n_rows if b else 0 for b in per)
            rows = _ceil_to(max(rows, self.config.row_pad),
                            self.config.row_pad)
            inst = np.zeros((n_dev, rows), np.int32)
            part = [np.zeros((n_dev, rows, w), np.int32)
                    for _ in range(arity - 1)]
            val = np.zeros((n_dev, rows, w), dtype)
            mask = np.zeros((n_dev, rows, w), dtype)
            for d, b in enumerate(per):
                if b is None:
                    dev_inst[d].append(inst[d])
                    continue
                inst[d, :b.n_rows] = b.inst
                for k in range(arity - 1):
                    part[k][d, :b.n_rows] = b.part[k]
                val[d, :b.n_rows] = b.val
                mask[d, :b.n_rows] = b.mask
                dev_inst[d].append(inst[d])
            out.append({"inst": jnp.asarray(inst),
                        "part": [jnp.asarray(p) for p in part],
                        "val": jnp.asarray(val), "mask": jnp.asarray(mask)})
        return out, dev_inst

    def _stack_matvec(self, per_dev):
        """Unify bucket widths of per-device matvec layouts; stack axis 0."""
        n_dev = len(per_dev)
        widths = sorted({int(b["part"].shape[1])
                         for mv in per_dev for b in mv})
        out = []
        for w in widths:
            per = [next((b for b in mv if b["part"].shape[1] == w), None)
                   for mv in per_dev]
            rows = _ceil_to(max((b["part"].shape[0] if b else 0)
                                for b in per) or self.config.row_pad,
                            self.config.row_pad)
            inst = np.zeros((n_dev, rows), np.int32)
            part = np.zeros((n_dev, rows, w), np.int32)
            wv = np.zeros((n_dev, rows, w), self.config.np_dtype())
            for d, b in enumerate(per):
                if b is None:
                    continue
                r = b["part"].shape[0]
                inst[d, :r] = np.asarray(b["inst"])
                part[d, :r] = np.asarray(b["part"])
                wv[d, :r] = np.asarray(b["w"])
            out.append({"inst": jnp.asarray(inst),
                        "part": jnp.asarray(part),
                        "w": jnp.asarray(wv)})
        return out

    def flops_per_sweep(self) -> float:
        """Approximate matmul work of one sweep (same accounting as
        models.engine.CompiledProblem.flops_per_sweep; diagnostic only —
        feeds bench.py's effective-TOPS report).  Dense/fused modes count
        their PADDED shard extents (that IS the executed work)."""
        K = self.config.num_latent
        C = K * (K + 1) // 2
        f = 0.0
        for ri, rs in enumerate(self.rel_specs):
            total_pad = float(np.prod(
                [self.ent_meta[e].n_pad for e in rs.entity_ids]))
            for mode in range(rs.arity):
                if (ri, mode) in self.dense_plans:
                    f += 2.0 * total_pad * (C + K)
                else:
                    f += 2.0 * rs.nnz * (K * K + K)
        for es in self.entity_specs:
            if not es.has_features:
                continue
            N, F = float(es.n), float(es.num_features)
            xpass = 2.0 * N * F * K
            f += xpass
            if es.use_ff:
                f += F ** 3 / 3.0 + 2.0 * F * F * K + xpass
            elif es.solver == "dual":
                r = float(self.config.dual_refine)
                f += 2.0 * xpass + (4.0 * (1.0 + r) + 2.0 * r) * N * N * K
            else:
                f += xpass
        return f

    def _shard_tuples(self, idx: np.ndarray, vals: np.ndarray, dtype):
        """Block-partition a tuple list across devices (sequential order)."""
        n = idx.shape[0]
        n_dev = self.n_dev
        per = _ceil_to(max(-(-n // n_dev), 1), 8)
        D = idx.shape[1]
        out_idx = np.zeros((n_dev, per, D), np.int32)
        out_val = np.zeros((n_dev, per), dtype)
        out_w = np.zeros((n_dev, per), dtype)
        counts = []
        for d in range(n_dev):
            s, e = d * per, min((d + 1) * per, n)
            cnt = max(e - s, 0)
            counts.append(cnt)
            if cnt:
                out_idx[d, :cnt] = idx[s:e]
                out_val[d, :cnt] = vals[s:e]
                out_w[d, :cnt] = 1.0
        return ({"idx": jnp.asarray(out_idx), "vals": jnp.asarray(out_val),
                 "w": jnp.asarray(out_w)}, counts)


class ShardedMacauEngine(GibbsDriverMixin):
    """shard_map Gibbs engine over a 1-D device mesh (API mirrors
    MacauEngine, including the full run() aux-subsystem surface:
    metrics_every batching, log_file, output_prefix, checkpoint_every,
    trace_dir — one shared driver loop; SURVEY §7.7)."""

    def __init__(self, rd: RelationData, config: MacauConfig,
                 mesh: Optional[Mesh] = None):
        enable_compile_cache()
        self.rd = rd
        self.config = config
        self.mesh = mesh if mesh is not None else data_mesh()
        self.n_dev = self.mesh.devices.size
        self.problem = ShardedProblem(rd, config, self.n_dev)
        self.dtype = jnp.dtype(config.dtype)

        p = self.problem
        # commit the static arrays to their mesh shardings ONCE — otherwise
        # every jit call re-lays-out hundreds of MB of layout arrays
        from jax.sharding import NamedSharding
        self._shard_d = NamedSharding(self.mesh, P(AXIS))
        self._shard_rep = NamedSharding(self.mesh, P())
        p.arrays_sh = jax.tree.map(
            lambda x: jax.device_put(x, self._shard_d), p.arrays_sh)
        p.arrays_rep = jax.tree.map(
            lambda x: jax.device_put(x, self._shard_rep), p.arrays_rep)
        specs_sh = jax.tree.map(lambda _: P(AXIS), p.arrays_sh)
        specs_rep = jax.tree.map(lambda _: P(), p.arrays_rep)
        state_rep_t, state_sh_t = self.init_state()
        s_rep_spec = jax.tree.map(lambda _: P(), state_rep_t)
        s_sh_spec = jax.tree.map(lambda _: P(AXIS), state_sh_t)
        rnd_sh_spec, rnd_rep_spec = self._randoms_specs()

        local = partial(_local_sweep, p)
        shmap = jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(specs_sh, specs_rep, s_rep_spec, s_sh_spec,
                      rnd_sh_spec, rnd_rep_spec, P()),
            out_specs=(s_rep_spec, s_sh_spec, P()),
            check_vma=False)


        def keyed(arrays_sh, arrays_rep, state_rep, state_sh, key, acc):
            randoms = draw_all(key, p.random_spec, self.dtype)
            rnd_sh, rnd_rep = self._split_randoms(randoms)
            return shmap(arrays_sh, arrays_rep, state_rep, state_sh,
                         rnd_sh, rnd_rep, acc)

        self._sweep_jit = jax.jit(keyed, donate_argnums=(2, 3))
        self._shmap = shmap
        self._keyed = keyed
        self._batch_jits = {}  # chunk size -> scan jit
        # run() dispatches the draws as a SEPARATE jit: fusing draw+split
        # into the shard_map program once triggered an XLA scheduling
        # pathology.  out_shardings pins the draws to their mesh layout
        # at birth so the shmap call does not reshard them.
        rnd_out_sh = (
            jax.tree.map(lambda _: self._shard_d, rnd_sh_spec),
            jax.tree.map(lambda _: self._shard_rep, rnd_rep_spec))
        self._rnd_jit = jax.jit(
            lambda key: self._split_randoms(
                draw_all(key, p.random_spec, self.dtype)),
            out_shardings=rnd_out_sh)
        # donate state only: the rnd trees have no same-shaped outputs to
        # alias (donating them just warns "donated buffers not usable")
        self._shmap_jit = jax.jit(shmap, donate_argnums=(2, 3))

    # -- randoms routing -----------------------------------------------------
    def _sharded_names(self):
        out = {}
        for ei, es in enumerate(self.problem.entity_specs):
            out[f"e{ei}.xi"] = ei
            if es.has_features:
                out[f"e{ei}.beta_e1"] = ei
        return out

    def _randoms_specs(self):
        sh, rep = {}, {}
        shard_names = self._sharded_names()
        for name in self.problem.random_spec:
            if name in shard_names:
                sh[name] = P(AXIS)
            else:
                rep[name] = P()
        return sh, rep

    def _split_randoms(self, randoms):
        """Permute+pad per-instance draws into the shard layout."""
        sh, rep = {}, {}
        shard_names = self._sharded_names()
        for name, arr in randoms.items():
            if name in shard_names:
                ei = shard_names[name]
                meta = self.problem.ent_meta[ei]
                perm = jnp.asarray(self.problem.perms[ei])
                a = jnp.take(arr, perm, axis=0)
                pad = meta.n_pad - meta.n
                if pad:
                    a = jnp.concatenate(
                        [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
                sh[name] = a
            else:
                rep[name] = arr
        return sh, rep

    # -- state ---------------------------------------------------------------
    def init_state(self, key: Optional[jax.Array] = None):
        """Replicated + sharded state halves.

        U init matches MacauEngine.init_state draws (original order), then
        permutes into shard layout — so single-device and sharded runs
        start identically.
        """
        cfg = self.config
        K = cfg.num_latent
        dtype = self.dtype
        if key is None:
            key = jax.random.key(cfg.seed)
        state_rep: Dict[str, Any] = {"ent": [], "rel": []}
        state_sh: Dict[str, Any] = {"uhat": {}, "pred": {}}
        for ei, es in enumerate(self.problem.entity_specs):
            meta = self.problem.ent_meta[ei]
            k = jax.random.fold_in(key, 1000 + ei)
            U0 = cfg.init_std * jax.random.normal(k, (es.n, K), dtype)
            U0 = jnp.take(U0, jnp.asarray(self.problem.perms[ei]), axis=0)
            if meta.n_pad > meta.n:
                U0 = jnp.concatenate(
                    [U0, jnp.zeros((meta.n_pad - meta.n, K), dtype)])
            ent = {"U": U0, "mu": jnp.zeros((K,), dtype),
                   "Lambda": jnp.eye(K, dtype=dtype)}
            if es.has_features:
                ent["beta"] = jnp.zeros((es.num_features, K), dtype)
                ent["lambda_beta"] = jnp.asarray(
                    self.problem.init_lambda_beta[ei], dtype)
                state_sh["uhat"][f"e{ei}"] = jnp.zeros(
                    (self.n_dev, meta.n_loc, K), dtype)
            state_rep["ent"].append(ent)
        for ri in range(len(self.problem.rel_specs)):
            state_rep["rel"].append(
                {"alpha": jnp.asarray(self.problem.init_alpha[ri], dtype)})
        for ri, rs in enumerate(self.problem.rel_specs):
            if rs.n_test:
                per = self.problem.arrays_sh["test"][f"r{ri}"]["w"].shape[1]
                state_sh["pred"][f"r{ri}"] = {
                    "sum": jnp.zeros((self.n_dev, per), dtype),
                    "sum2": jnp.zeros((self.n_dev, per), dtype),
                    "n": jnp.zeros((self.n_dev,), dtype)}
        state_rep = jax.tree.map(
            lambda x: jax.device_put(x, self._shard_rep), state_rep)
        state_sh = jax.tree.map(
            lambda x: jax.device_put(x, self._shard_d), state_sh)
        return state_rep, state_sh

    # -- driver hooks (GibbsDriverMixin supplies run()) ----------------------
    def _do_sweep(self, state, skey, accumulate, **_lookahead):
        state_rep, state_sh = state
        p = self.problem
        rnd_sh, rnd_rep = self._rnd_jit(skey)
        state_rep, state_sh, metrics = self._shmap_jit(
            p.arrays_sh, p.arrays_rep, state_rep, state_sh, rnd_sh,
            rnd_rep, accumulate)
        return (state_rep, state_sh), metrics

    def _do_sweeps_batch(self, state, base_key, start: int, n: int):
        """Scan-batched multi-sweep dispatch (config sweeps_per_dispatch).

        Draws happen inside the scan body (the separate-program draw
        dispatch of `_do_sweep` cannot cross a scan boundary); per-sweep
        streams/flags are identical to the single-sweep path."""
        fn = self._batch_jits.get(n)
        if fn is None:
            burnin = self.config.burnin
            keyed = self._keyed

            def scan_fn(arrays_sh, arrays_rep, st, key, start):
                def body(st, s):
                    skey = sweep_key(key, s + 1)
                    acc = (s >= burnin).astype(self.dtype)
                    state_rep, state_sh = st
                    sr, ss, m = keyed(arrays_sh, arrays_rep, state_rep,
                                      state_sh, skey, acc)
                    return (sr, ss), m
                return jax.lax.scan(body, st,
                                    start + jnp.arange(n, dtype=jnp.int32))

            fn = jax.jit(scan_fn, donate_argnums=(2,))
            self._batch_jits[n] = fn
        p = self.problem
        return fn(p.arrays_sh, p.arrays_rep, state, base_key,
                  jnp.asarray(start, jnp.int32))

    def _save_sample(self, prefix: str, psample_idx: int, state) -> None:
        """Posterior-sample dump in ORIGINAL instance order so saved
        samples feed predict_out_of_matrix exactly like the single-device
        engine's (SURVEY §7.4)."""
        state_rep, _ = state
        st = jax.device_get(state_rep)
        out = {}
        U_orig = self.factors_original_order(state_rep)
        for ei, ent in enumerate(st["ent"]):
            for k, v in ent.items():
                out[f"e{ei}.{k}"] = U_orig[ei] if k == "U" else v
        for ri, rel in enumerate(st["rel"]):
            out[f"r{ri}.alpha"] = rel["alpha"]
        np.savez(f"{prefix}-sample{psample_idx:04d}.npz", **out)

    def _results(self, state, history):
        state_rep, state_sh = state
        out: Dict[str, Any] = {"state": state, "history": history}
        sh_np = jax.device_get(state_sh)
        for ri, rs in enumerate(self.problem.rel_specs):
            pk = f"r{ri}"
            if pk not in sh_np["pred"]:
                continue
            meta = self.problem.test_meta[ri]
            pr = sh_np["pred"][pk]
            n = max(float(pr["n"][0]), 1.0)
            # strip per-device padding and restore original order
            chunks_m, chunks_v = [], []
            for d, cnt in enumerate(meta["counts"]):
                chunks_m.append(pr["sum"][d, :cnt] / n)
                chunks_v.append(pr["sum2"][d, :cnt] / n)
            pmean = np.concatenate(chunks_m) if chunks_m else np.zeros(0)
            psq = np.concatenate(chunks_v) if chunks_v else np.zeros(0)
            pvar = np.maximum(psq - pmean ** 2, 0.0)
            te_val = meta["vals"]
            rmse = float(np.sqrt(np.mean((pmean - te_val) ** 2)))
            rel_out = {"RMSE": rmse,
                       "predictions": {"idx": meta["orig_idx"],
                                       "obs": te_val, "pred": pmean,
                                       "stdev": np.sqrt(pvar)}}
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

    # -- checkpoint/resume (SURVEY §7.4); counter-based RNG => exact ------
    def save_state(self, path: str, state, sweep: int) -> None:
        state_rep, state_sh = state
        flat, _ = jax.tree_util.tree_flatten(
            jax.device_get((state_rep, state_sh)))
        np.savez(path, sweep=sweep, n_leaves=len(flat),
                 **{f"leaf{i}": a for i, a in enumerate(flat)})

    def load_state(self, path: str):
        z = np.load(path)
        template = self.init_state()
        flat, treedef = jax.tree_util.tree_flatten(template)
        leaves = [jnp.asarray(z[f"leaf{i}"]) for i in range(len(flat))]
        return (jax.tree_util.tree_unflatten(treedef, leaves),
                int(z["sweep"]))

    def factors_original_order(self, state_rep) -> List[np.ndarray]:
        """U matrices back in original instance order (for tests/inspection)."""
        out = []
        for ei, es in enumerate(self.problem.entity_specs):
            U = np.asarray(jax.device_get(state_rep["ent"][ei]["U"]))
            perm = self.problem.perms[ei]
            orig = np.empty((es.n, U.shape[1]), U.dtype)
            orig[perm] = U[:es.n]  # position p holds original id perm[p]
            out.append(orig)
        return out


# ---------------------------------------------------------------------------
# The per-device sweep body (runs under shard_map)
# ---------------------------------------------------------------------------

def _dense_partner_n(problem: ShardedProblem, ri: int, mode: int):
    """True (unpadded) row count of the partner factor table for an int8
    dense mode — the quantization scales must be computed over the valid
    rows only so they match the single-device engine bitwise (pad rows'
    latents are prior draws; ops/dense_gram._quantize_cols)."""
    if problem.dense_w_scale.get((ri, mode)) is None:
        return None
    rs = problem.rel_specs[ri]
    return [problem.ent_meta[rs.entity_ids[d]].n
            for d in range(rs.arity) if d != mode]


def _local_sweep(problem: ShardedProblem, arrays_sh, arrays_rep,
                 state_rep, state_sh, rnd_sh, rnd_rep, accumulate):
    cfg = problem.config
    K = cfg.num_latent
    dtype = jnp.dtype(cfg.dtype)
    nu0 = cfg.resolved_nu0()
    me = jax.lax.axis_index(AXIS)
    psum = partial(jax.lax.psum, axis_name=AXIS)

    # strip the leading (length-1 local) device axis from stacked arrays
    def loc(tree):
        return jax.tree.map(lambda x: x[0], tree)

    layouts = loc(arrays_sh["layouts"])
    rowmask = loc(arrays_sh["rowmask"])
    tests = loc(arrays_sh["test"])
    trains = loc(arrays_sh["train"])
    feats = loc(arrays_sh["feat"])
    uhat_sh = loc(state_sh["uhat"])
    preds = loc(state_sh["pred"])

    ents = [dict(e) for e in state_rep["ent"]]
    rels = [dict(r) for r in state_rep["rel"]]
    metrics: Dict[str, jax.Array] = {}

    for ei, es in enumerate(problem.entity_specs):
        meta = problem.ent_meta[ei]
        ent = ents[ei]
        Lambda = ent["Lambda"]
        offset = me * meta.n_loc
        U_loc = jax.lax.dynamic_slice_in_dim(ent["U"], offset, meta.n_loc, 0)
        w_row = rowmask[f"e{ei}"]                       # [n_loc]
        uhat_loc = uhat_sh.get(f"e{ei}")

        if es.has_features:
            beta, uhat_loc, cg_diag = _sample_beta_sharded(
                problem, ei, es, feats[f"e{ei}"],
                arrays_rep["ftf"].get(f"e{ei}"),
                arrays_rep["nys"].get(f"e{ei}"), ent, U_loc,
                rnd_sh[f"e{ei}.beta_e1"], rnd_rep[f"e{ei}.beta_e2"], psum)
            ent["beta"] = beta
            uhat_sh[f"e{ei}"] = uhat_loc
            if cg_diag is not None:
                metrics[f"e{ei}.cg_iters"] = cg_diag[0]
                metrics[f"e{ei}.cg_resid"] = cg_diag[1]
            if cfg.sample_lambda_beta:
                ent["lambda_beta"] = sample_lambda_beta(
                    beta, Lambda, rnd_rep[f"e{ei}.lb_g"],
                    cfg.nu_beta, cfg.lambda_beta_mean)
            metrics[f"e{ei}.betanorm"] = jnp.linalg.norm(beta)
            metrics[f"e{ei}.lambda_beta"] = ent["lambda_beta"]

        # --- Normal-Wishart from psum-reduced moments (SURVEY §4.3) ---
        S_loc = U_loc - uhat_loc if uhat_loc is not None else U_loc
        n_real = es.n
        Sbar = psum(jnp.sum(S_loc * w_row[:, None], axis=0)) / n_real
        Sc = (S_loc - Sbar) * w_row[:, None]
        scatter = psum(Sc.T @ Sc)
        mu, Lambda = normal_wishart_from_moments(
            n_real, Sbar, scatter, cfg.nw_b0, nu0,
            2.0 * rnd_rep[f"e{ei}.nw_g"], rnd_rep[f"e{ei}.nw_tri"],
            rnd_rep[f"e{ei}.nw_mu"])
        ent["mu"], ent["Lambda"] = mu, Lambda

        # --- local Gramian assembly + batched sample (SURVEY §4.2) ---
        prior_mean = jnp.broadcast_to(mu[None, :], (meta.n_loc, K))
        if uhat_loc is not None:
            prior_mean = prior_mean + uhat_loc
        contribs = []
        dense_contribs = []
        for ri, rs in enumerate(problem.rel_specs):
            for mode in range(rs.arity):
                if rs.entity_ids[mode] != ei:
                    continue
                partners = [ents[rs.entity_ids[d]]["U"]
                            for d in range(rs.arity) if d != mode]
                plan = problem.dense_plans.get((ri, mode))
                if plan is not None:
                    dims_sh = (meta.n_loc,) + tuple(
                        problem.ent_meta[rs.entity_ids[d]].n_pad
                        for d in range(rs.arity) if d != mode)
                    dense_contribs.append(
                        (rels[ri]["alpha"], partners, ri, mode, dims_sh,
                         plan))
                # hybrid fused relations carry residual buckets alongside
                # the dense plan (empty list otherwise)
                for ba in layouts[f"r{ri}m{mode}"]:
                    contribs.append((rels[ri]["alpha"], partners, ba))
        gd = jnp.dtype(cfg.gram_dtype) if cfg.gram_dtype else None

        def fused_contrib(ri, mode, partners, mdt, alpha=None):
            """Fused single-array mode under sharding: mode 0 contracts
            the local row slab (focus rows — no collectives); mode 1
            contracts the SHARDED axis against the owner's partner-row
            slice and psum_scatters the partial sums straight into each
            device's focus slice (n_pad is a multiple of n_dev).

            The s8 variant (problem.fused_i8) quantizes the FULL partner
            table (column-max scales over the valid prefix — permutation-
            invariant, so bitwise equal to the single-device engine's),
            contracts in exact int32, and for mode 1 psums the RAW int32
            partials before dequantizing — integer addition is
            associative, so the cross-device total equals the plain
            engine's single dot bit for bit.  The output is pre-scaled by
            ``alpha`` when given."""
            from ..ops import dense_gram as dgx
            rs = problem.rel_specs[ri]
            s_, m_ = problem.fused_rels[ri]
            dsl = loc(arrays_sh["dense"])[f"r{ri}"]
            V8 = dsl["V8"]
            i8 = problem.fused_i8.get(ri, False)
            if mode == 0:
                if i8:
                    return dgx.fused_gram_contrib_i8(
                        V8, partners[0], 0, dtype, s_, m_,
                        rs.mean_value,
                        n_valid=problem.ent_meta[rs.entity_ids[1]].n,
                        ridge_deg=dsl.get("deg_m0"), alpha=alpha)
                P0, b0 = dgx.fused_gram_contrib(
                    V8, partners[0], 0, dtype, mdt, s_, m_, rs.mean_value)
                if alpha is not None:
                    P0, b0 = alpha * P0, alpha * b0
                return P0, b0
            meta0 = problem.ent_meta[rs.entity_ids[0]]
            if i8:
                YZ8, Z8, s_yz, s_z = dgx.fused_quantize(partners[0],
                                                        meta0.n)
                YZ8l = jax.lax.dynamic_slice_in_dim(
                    YZ8, me * meta0.n_loc, meta0.n_loc, 0)
                Z8l = jax.lax.dynamic_slice_in_dim(
                    Z8, me * meta0.n_loc, meta0.n_loc, 0)
                PM_p, BV_p = dgx.fused_pair_contract_i8(V8, YZ8l, Z8l, 1)
                PM_d = jax.lax.psum_scatter(PM_p, AXIS, scatter_dimension=0,
                                            tiled=True)
                BV_d = jax.lax.psum_scatter(BV_p, AXIS, scatter_dimension=0,
                                            tiled=True)
                f64 = jnp.dtype(dtype) == jnp.float64
                P1, b1 = dgx.fused_finish_i8(
                    PM_d, BV_d, s_yz, s_z, K, dtype, s_, m_,
                    rs.mean_value, ridge_deg=dsl.get("deg_m1"),
                    alpha=(None if f64 else alpha))
                if alpha is not None and f64:
                    P1, b1 = alpha * P1, alpha * b1
                return P1, b1
            U0_loc = jax.lax.dynamic_slice_in_dim(
                partners[0], me * meta0.n_loc, meta0.n_loc, 0)
            P_part, b_part = dgx.fused_gram_contrib(
                V8, U0_loc, 1, dtype, mdt, s_, m_, rs.mean_value)
            P_d = jax.lax.psum_scatter(P_part, AXIS, scatter_dimension=0,
                                       tiled=True)
            b_d = jax.lax.psum_scatter(b_part, AXIS, scatter_dimension=0,
                                       tiled=True)
            if alpha is not None:
                P_d, b_d = alpha * P_d, alpha * b_d
            return P_d, b_d
        if meta.n_head:
            # head-entity splitting (SURVEY §7.7): ghost slots accumulate
            # the round-robined head observations on every device; psum
            # the ghost block and fold it into the owners' local slots
            prior_ext = jnp.concatenate(
                [prior_mean, jnp.zeros((meta.n_head, K), dtype)])
            P_acc, b_acc = assemble_precision(
                Lambda, prior_ext, contribs, meta.n_ext, gram_dtype=gd,
                fuse_lambda=True)  # Lambda added at the sampler
            hm = loc(arrays_sh["headmap"])[f"e{ei}"]
            P_g = psum(P_acc[meta.n_loc:])
            b_g = psum(b_acc[meta.n_loc:])
            P_acc = P_acc[:meta.n_loc].at[hm["slot"]].add(
                P_g * hm["own"][:, None, None])
            b_acc = b_acc[:meta.n_loc].at[hm["slot"]].add(
                b_g * hm["own"][:, None])
        elif cfg.accumulation == "planned":
            P_acc, b_acc = assemble_precision_planned(
                Lambda, prior_mean, contribs, meta.n_loc,
                loc(arrays_sh["acc_plan"])[f"e{ei}"], gram_dtype=gd)
        else:
            P_acc, b_acc = assemble_precision(
                Lambda, prior_mean, contribs, meta.n_loc, gram_dtype=gd)
        # dense contributions (ops/dense_gram.py): the local focus-
        # leading M/W slab against the replicated partner factors — row-
        # sharded contractions, no collectives (head rows accumulate fully
        # on their owner; added after the ghost fold, like the single-
        # device add)
        for alpha, partners, ri, mode, dims_sh, plan in dense_contribs:
            with jax.named_scope(f"dense_r{ri}m{mode}"):
                mdt = gd if gd is not None else dtype
                if plan.kind == "fused":
                    P_d, b_d = fused_contrib(ri, mode, partners, mdt,
                                             alpha=alpha)
                else:
                    sl = loc(arrays_sh["dense"])[f"r{ri}m{mode}"]
                    P_d, b_d = dense_gram_contrib(
                        sl["M"], sl["W"], partners, 0, dims_sh, dtype, mdt,
                        w_scale=problem.dense_w_scale.get((ri, mode)),
                        n_valid=_dense_partner_n(problem, ri, mode),
                        ridge_deg=sl.get("deg"),
                        alpha=alpha)       # folded into the scales
                P_acc = P_acc + P_d
                b_acc = b_acc + b_d
        xi_loc = rnd_sh[f"e{ei}.xi"]
        # --- sample + factor exchange, block-pipelined (SURVEY §7.7): the
        # local shard is sampled in `exchange_blocks` chunks and each
        # chunk's all-gather is issued immediately, so XLA's async
        # collectives overlap block b's exchange with block b+1's
        # Cholesky-sample (rows of one entity are conditionally
        # independent, so block order is irrelevant to the math) ---
        # head-split accumulators leave Lambda out (the ghost fold must
        # not psum it); the sampler adds it
        fused_lam = Lambda if meta.n_head else None

        def _samp(sl):
            return chol_sample_dispatch(cfg, P_acc[sl], b_acc[sl],
                                        xi_loc[sl], Lambda=fused_lam)

        n_blk = max(1, min(problem.exchange_blocks, meta.n_loc))
        blk = meta.n_loc // n_blk
        if n_blk == 1 or blk * n_blk != meta.n_loc:
            U_new_loc = _samp(slice(None))
            ent["U"] = jax.lax.all_gather(U_new_loc, AXIS, axis=0,
                                          tiled=True)
        else:
            chunks, gathered = [], []
            for c in range(n_blk):
                sl = slice(c * blk, (c + 1) * blk)
                u_c = _samp(sl)
                chunks.append(u_c)
                gathered.append(jax.lax.all_gather(u_c, AXIS, axis=0,
                                                   tiled=True))
            # interleave: global order = per-device [blk0|blk1|...], and
            # all_gather(tiled) of chunk c yields [n_dev*blk] rows that
            # belong at positions d*n_loc + c*blk
            n_dev_ax = jax.lax.axis_size(AXIS)
            parts = [g.reshape(n_dev_ax, blk, -1) for g in gathered]
            ent["U"] = jnp.concatenate(parts, axis=1).reshape(
                meta.n_pad, -1)
            U_new_loc = jnp.concatenate(chunks, axis=0)
        ents[ei] = ent
        metrics[f"e{ei}.unorm"] = jnp.sqrt(psum(jnp.sum(U_new_loc ** 2)))

    # --- alpha conditionals (SURVEY §4.5) ---
    for ri, rs in enumerate(problem.rel_specs):
        if not rs.alpha_sample:
            continue
        tr = trains[f"r{ri}"]
        factors = [ents[eid]["U"] for eid in rs.entity_ids]
        pred_c = predict_tuples(factors, tr["idx"], jnp.asarray(0.0, dtype))
        sse = psum(jnp.sum(tr["w"] * (tr["vals"] - pred_c) ** 2))
        rels[ri] = {"alpha": sample_alpha(
            sse, rs.nnz, rnd_rep[f"r{ri}.alpha_g"],
            cfg.alpha_a0, cfg.alpha_b0)}
        metrics[f"r{ri}.alpha"] = rels[ri]["alpha"]

    # --- predictions (SURVEY §4.7) ---
    acc = jnp.asarray(accumulate, dtype)
    for ri, rs in enumerate(problem.rel_specs):
        pk = f"r{ri}"
        if pk not in preds:
            continue
        te = tests[pk]
        factors = [ents[eid]["U"] for eid in rs.entity_ids]
        pv = predict_tuples(factors, te["idx"],
                            jnp.asarray(rs.mean_value, dtype))
        if cfg.clamp is not None:
            pv = jnp.clip(pv, cfg.clamp[0], cfg.clamp[1])
        pr = dict(preds[pk])
        pr["sum"] = pr["sum"] + acc * pv * te["w"]
        pr["sum2"] = pr["sum2"] + acc * pv * pv * te["w"]
        pr["n"] = pr["n"] + acc
        preds[pk] = pr
        err2 = psum(jnp.sum(te["w"] * (pv - te["vals"]) ** 2))
        metrics[f"{pk}.rmse_sample"] = jnp.sqrt(err2 / rs.n_test)
        n_eff = jnp.maximum(pr["n"], 1.0)
        e2avg = psum(jnp.sum(
            te["w"] * (pr["sum"] / n_eff - te["vals"]) ** 2))
        metrics[f"{pk}.rmse_avg"] = jnp.sqrt(e2avg / rs.n_test)
        if rs.class_cut is not None:
            # per-sweep AUC: all-gather the (small) test chunks so every
            # device computes the identical global midrank statistic;
            # padded entries go to +inf with weight 0 (engine.auc_device)
            from ..models.engine import auc_device
            pmean = pr["sum"] / n_eff
            pm_g = jax.lax.all_gather(pmean, AXIS, axis=0).reshape(-1)
            v_g = jax.lax.all_gather(te["vals"], AXIS, axis=0).reshape(-1)
            w_g = jax.lax.all_gather(te["w"], AXIS, axis=0).reshape(-1)
            labels = (v_g < rs.class_cut).astype(dtype) * w_g
            scores = jnp.where(w_g > 0, -pm_g, jnp.inf)
            metrics[f"{pk}.auc"] = auc_device(labels, scores, weights=w_g)

    # re-attach the local device axis for sharded outputs
    def unloc(tree):
        return jax.tree.map(lambda x: x[None], tree)

    new_state_rep = {"ent": ents, "rel": rels}
    new_state_sh = {"uhat": unloc(uhat_sh), "pred": unloc(preds)}
    return new_state_rep, new_state_sh, metrics


def _sample_beta_sharded(problem, ei, es, feat, ftf, nys, ent, U_loc,
                         e1_loc_raw, e2_raw, psum):
    """Sharded noise-injected beta draw (SURVEY §4.4): the feature matrix
    is row-sharded by instance owner as per-device BUCKETED layouts
    (ops/spmv.py); X'(Xv) partials psum-reduce — the ParallelSBM
    equivalent, on the fast gather+einsum path with Jacobi PCG."""
    from ..ops.spmv import bucketed_spmm
    cfg = problem.config
    dtype = jnp.dtype(cfg.dtype)
    F = es.num_features
    n_loc = problem.ent_meta[ei].n_loc
    mu, Lambda, lam = ent["mu"], ent["Lambda"], ent["lambda_beta"]
    cg_diag = None

    L = lxl.cholesky(Lambda)

    def colored(z):
        return lxl.triangular_solve(L, z.T, left_side=True, lower=True,
                                    transpose_a=True).T

    Xd = feat.get("dense_X")
    if Xd is not None:
        # full compute-dtype precision — see models/engine.py spmm note
        # (bf16 V operands amplify to ~1e-1 beta-draw residual)
        hi = jax.lax.Precision.HIGHEST if dtype == jnp.float32 else None

        def spmm_fwd(V):
            return jnp.einsum("nf,fk->nk", Xd.astype(dtype), V,
                              preferred_element_type=dtype, precision=hi)

        def spmm_t(V):
            return psum(jnp.einsum("nf,nk->fk", Xd.astype(dtype), V,
                                   preferred_element_type=dtype,
                                   precision=hi))
    else:
        def spmm_fwd(V):
            return bucketed_spmm(feat["fwd"], n_loc, V)

        def spmm_t(V):
            return psum(bucketed_spmm(feat["t"], F, V))

    E1 = colored(e1_loc_raw)
    E2 = colored(e2_raw)
    resid = U_loc - mu[None, :] + E1
    rhs = spmm_t(resid) + jnp.sqrt(lam) * E2

    if es.use_ff:
        A = ftf + lam * jnp.eye(F, dtype=dtype)
        Lf = lxl.cholesky(A)
        y = lxl.triangular_solve(Lf, rhs, left_side=True, lower=True)
        beta = lxl.triangular_solve(Lf, y, left_side=True, lower=True,
                                    transpose_a=True)
    elif es.solver == "dual":
        # Woodbury exact solve with N-space refinement (ops/dual.py
        # dual_solve_g, sharded form): Q/G row-sharded by instance owner;
        # Q't psum-reduces, the G z product all-gathers the [n_pad, K] z
        # (2 MB — cheap); uhat = z_loc directly (push-through identity)
        Qloc = feat["dual_Q"]                       # [n_loc, N]
        dd = feat["dual_d"]                         # [N]
        Gloc = feat["dual_G"]                       # [n_loc, n_pad]
        hiq = jax.lax.Precision.HIGHEST  # see ops/dual.py cancellation note

        def apply_inv_loc(t_loc):
            s = psum(jnp.matmul(Qloc.T, t_loc, precision=hiq))
            s = s / (dd + lam)[:, None]
            return jnp.matmul(Qloc, s, precision=hiq)

        t0_loc = spmm_fwd(rhs)                      # [n_loc, K]
        z_loc = apply_inv_loc(t0_loc)
        for _ in range(cfg.dual_refine):
            z_full = jax.lax.all_gather(z_loc, AXIS, axis=0, tiled=True)
            r_loc = (t0_loc - jnp.matmul(Gloc, z_full, precision=hiq)
                     - lam * z_loc)
            z_loc = z_loc + apply_inv_loc(r_loc)
        beta = (rhs - spmm_t(z_loc)) / lam          # spmm_t psums
        return beta, z_loc, None
    else:
        def matvec(V):
            return spmm_t(spmm_fwd(V)) + lam * V
        tol = cfg.cg_tol if jnp.dtype(cfg.dtype) == jnp.float64 \
            else max(cfg.cg_tol, 1e-5)
        precond = None
        if nys is not None:
            from ..ops.precond import nystrom_apply
            precond = lambda r: nystrom_apply(  # noqa: E731
                nys["U"], nys["d"], lam, r)
        beta, it, resid = block_cg(matvec, rhs, ent["beta"],
                                   tol=tol, maxiter=cfg.cg_maxiter,
                                   precond_diag=feat["colcount"] + lam,
                                   precond=precond)
        cg_diag = (it, resid)

    uhat_loc = spmm_fwd(beta)
    return beta, uhat_loc, cg_diag
