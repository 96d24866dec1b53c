"""Dense Gramian accumulation: turn the sparse gather into a matmul.

The per-instance precision assembly (reference: the per-row ``sample_user``
loop, src/macau.jl [MED]; SURVEY.md §4.2/§5.4) is

    P_i = sum_{o in Omega_i} z_o z_o^T ,    b_i = sum_o (v_o - mean) z_o

The bucketed path (ops/gramian.py) gathers partner rows per observation,
and its cost grows with nnz whatever the density.  At typical fusion
densities the matmul formulation wins: with the
static 0/1 observation matrix ``M [N, Np]`` and centered-value matrix
``W [N, Np]`` (both constants of the run), and ``Y [Np, K^2]`` the per-row
outer products of the partner factors,

    P = M @ Y  (reshaped to [N, K, K]),      b = W @ Z

— two big matmuls with f32 accumulation instead of nnz row gathers.  The
M @ Y matmul does ``2 N Np K^2`` FLOPs of which only ``density`` is useful,
so dense wins when the matmul rate exceeds the gather's effective rate by
more than 1/density (ML-10M: 1.3%; ChEMBL IC50: 5.8%).  The planner below
decides per mode from measured machine constants.
Duplicate observations are summed into M/W at build time, which matches the
gather path's per-observation accumulation exactly.

Tensor relations (arity >= 3) contract the canonical dense tensor
``T [N_0, ..., N_{D-1}]`` with ONE multi-operand einsum per mode,
``P_m = einsum(T, Y_0, ..,skip m,.., Y_{D-1})`` — the Hadamard context
factorizes through the outer product ((z o w)(z o w)^T = zz^T o ww^T), and
opt_einsum's pairwise path contracts the largest axis first, so no
[prod(N_d), K^2] Hadamard table is ever materialized and every mode shares
the same stored array (no permuted copies).
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Measured machine constants used by the auto heuristic: NVIDIA H100 80GB
# HBM3, power limit 700 W, measured by chip_smoke.py's probe phase at the
# ML-10M and ChEMBL bench shapes (K=32).  They only steer the
# dense-vs-gather choice; correctness is identical either way.
# gather + einsum + segment-sum of the bucketed layout, per observation
# (bf16 gram dtype; partner tables of these shapes sit in the 50 MB L2)
_GATHER_S_PER_OBS = 1.69e-10
# the rate at which estimate_times reproduces the measured s8 dense-pair
# contraction of both ML-10M modes (13.9 ms)
_MATMUL_FLOPS = 1.21e14
# a 4 GiB f32 read + write
_HBM_BPS = 2.93e12
# Auto mode never fires below this nnz: tiny problems (the test suite) stay
# on the gather path, keeping compile times and test seams unchanged.
_AUTO_MIN_NNZ = 50_000
# Bucketed feature-matvec cost per nnz PASS (one X'(Xv) = two passes) at
# the ChEMBL bench feature matrix (15k x 32k, ~600k nnz)
_SPMM_S_PER_NNZ = 2.57e-10
# Chunked-mask bf16 fused contraction at the ML-10M shape, as the rate at
# which estimate_times reproduces its measured time (20.0 ms, both modes)
_BF16_FLOPS = 8.29e13


class DenseModePlan:
    """How one (relation, mode) contracts against the stored dense pair.

    kind: 'canonical' — multi-operand einsum against the shared canonical
                        tensor (single-device engine; all modes share)
          'copy'      — own focus-leading [N_m, prod] slab (sharded engine:
                        each mode's pair is sharded by its own focus axis)
    """

    def __init__(self, kind: str, n_focus: int, partner_counts: Tuple[int, ...]):
        self.kind = kind
        self.n_focus = n_focus
        self.partner_counts = partner_counts


def estimate_times(n_focus: int, np_comb: int, nnz: int, K: int,
                   itemsize: int,
                   matmul_rate: Optional[float] = None
                   ) -> Tuple[float, float]:
    """(dense_seconds, gather_seconds) for one mode update.

    The dominant pairwise contraction of the mode einsum touches every
    tensor element once against the K(K+1)/2-column packed triangle; the
    rhs product streams W once more.  ``matmul_rate`` lets callers model a
    path that runs at a different matmul rate (the fused single-array
    path contracts in bf16, not s8).
    """
    flops = 2.0 * n_focus * np_comb * (K * (K + 1) // 2)
    bytes_mw = n_focus * np_comb * itemsize                # each of M, W
    # The Gramian matmul is compute-bound (arithmetic intensity ~K^2/
    # itemsize >> ridge) so M's streaming hides under the matmul; W @ Z
    # is bandwidth-bound.
    rate = _MATMUL_FLOPS if matmul_rate is None else matmul_rate
    dense = (max(flops / rate, bytes_mw / _HBM_BPS)
             + bytes_mw / _HBM_BPS)
    # The gather path's cost is calibrated at K=32 and grows ~K^2 beyond
    # it: the per-observation row gather moves K-proportional bytes and
    # the segment-sum streams [rows, K^2] scatter traffic.
    gather = nnz * _GATHER_S_PER_OBS * max(1.0, (K / 32.0) ** 2)
    return dense, gather


def plan_dense_modes(
    shapes: Sequence[Tuple[int, ...]],   # per relation: entity counts
    nnzs: Sequence[int],
    K: int,
    dense_gram: Optional[bool],          # None=auto, False=off, True=force
    budget_bytes: float,
    itemsize,                            # int, or per-relation sequence
                                         # (1 for int8-eligible relations)
    per_mode_pairs: bool = False,        # sharded engine: every mode owns
                                         # its focus-sharded pair (no
                                         # canonical-array sharing)
):
    """Decide which (relation, mode) pairs run dense.

    Returns (plans, canonical_rels, copy_keys):
      plans: dict  (ri, mode) -> DenseModePlan
      canonical_rels: set of ri needing the canonical [prod(shape)] pair
      copy_keys: list of (ri, mode) needing a permuted copy
    """
    plans = {}
    canonical: set = set()
    copies: List[Tuple[int, int]] = []
    if dense_gram is False:
        return plans, canonical, copies
    spent = 0.0

    # candidate list: (priority = est. time saved, ri, mode, extra bytes)
    cands = []
    for ri, shape in enumerate(shapes):
        nnz = nnzs[ri]
        if nnz == 0:
            continue
        if dense_gram is None and nnz < _AUTO_MIN_NNZ:
            continue
        its = itemsize[ri] if np.ndim(itemsize) else itemsize
        total = int(np.prod([int(s) for s in shape], dtype=np.int64))
        pair_bytes = 2.0 * total * its               # M + W (shared per rel)
        for mode in range(len(shape)):
            n_focus = int(shape[mode])
            np_comb = total // n_focus
            dense_t, gather_t = estimate_times(n_focus, np_comb, nnz, K,
                                               its)
            if dense_gram is None and dense_t > 0.7 * gather_t:
                continue
            kind = "copy" if per_mode_pairs else "canonical"
            extra = pair_bytes if kind == "copy" else 0.0
            cands.append((gather_t - dense_t, ri, mode, kind, extra,
                          n_focus, shape))
    # greedy by estimated saving, respecting the budget; the canonical pair
    # is charged once per relation when first used
    cands.sort(key=lambda c: -c[0])
    for saving, ri, mode, kind, extra, n_focus, shape in cands:
        total = int(np.prod([int(s) for s in shape], dtype=np.int64))
        need = extra
        if kind != "copy" and ri not in canonical:
            its = itemsize[ri] if np.ndim(itemsize) else itemsize
            need += 2.0 * total * its
        if spent + need > budget_bytes:
            # no silent caps: a budget-declined mode silently riding the
            # (much slower) gather path cost a round of debugging once
            import sys
            print(f"# dense_gram: relation {ri} mode {mode} declined by "
                  f"budget ({(spent + need) / 1e9:.2f} GB > "
                  f"{budget_bytes / 1e9:.2f} GB) — gather path",
                  file=sys.stderr)
            continue
        spent += need
        if kind == "copy":
            copies.append((ri, mode))
        else:
            canonical.add(ri)
        partner_counts = tuple(int(s) for d, s in enumerate(shape)
                               if d != mode)
        plans[(ri, mode)] = DenseModePlan(kind, n_focus, partner_counts)
    return plans, canonical, copies


def plan_fused_rels(
    shapes: Sequence[Tuple[int, ...]],
    nnzs: Sequence[int],
    K: int,
    dense_gram: Optional[bool],          # master dense switch
    dense_fused: Optional[bool],         # None=auto, False=off, True=force
    fused_enc: Sequence,                 # per relation: (s, m) or None
    pair_itemsize: Sequence[int],        # what the PAIR path would store
    budget_bytes: float,
):
    """Pick relations for the SINGLE-ARRAY fused dense path.

    Auto rule (the sparse-regime answer, VERDICT r2 #1): engage when the
    relation is fused-encodable, the dense contraction beats the gather
    at the bf16 rate, and the M/W pair does NOT fit the budget while the
    single int8 array does — Netflix-shaped relations (480k x 18k, 100M
    nnz: 17 GB pair vs 8.5 GB single) land here.  ``dense_fused=True``
    forces it wherever encodable (test/ablation knob).

    Decided from relation-level statistics only — NEVER from an engine's
    storage layout — so the single-device and sharded engines always
    make the same choice (the engine-parity invariant).

    Returns (fused: dict ri -> (s, m), spent_bytes).
    """
    out = {}
    spent = 0.0
    if dense_fused is False or dense_gram is False:
        return out, spent
    for ri, shape in enumerate(shapes):
        if fused_enc[ri] is None or len(shape) != 2:
            continue
        nnz = nnzs[ri]
        if dense_fused is None and nnz < _AUTO_MIN_NNZ:
            continue
        total = float(int(shape[0]) * int(shape[1]))
        if dense_fused is None:
            pair_bytes = 2.0 * total * pair_itemsize[ri]
            if pair_bytes <= budget_bytes:
                continue                 # the faster s8/bf16 pair path fits
            profitable = all(
                (lambda d_g: d_g[0] < 0.7 * d_g[1])(estimate_times(
                    int(shape[m]), int(shape[1 - m]), nnz, K, 1,
                    matmul_rate=_BF16_FLOPS))
                for m in range(2))
            if not profitable:
                continue
        if spent + total > budget_bytes:
            import sys
            print(f"# dense_gram: relation {ri} fused path declined by "
                  f"budget ({(spent + total) / 1e9:.2f} GB > "
                  f"{budget_bytes / 1e9:.2f} GB) — gather path",
                  file=sys.stderr)
            continue
        out[ri] = fused_enc[ri]
        spent += total
    return out, spent


def use_dense_feat(n: int, f: int, nnz: int, itemsize: int,
                   dense_gram: Optional[bool]) -> bool:
    """Dense [N, F] feature matrix for the beta matvec (SURVEY §4.4)?

    The CG matvec ``X'(X v)`` on the bucketed sparse layout pays a
    per-nnz gather cost like the Gramian's; streaming a dense X twice per
    iteration is bandwidth-bound and wins at ECFP-scale density (decided
    from _SPMM_S_PER_NNZ and _HBM_BPS).  Capped at 2 GB.
    """
    bytes_x = float(n) * f * itemsize
    if dense_gram is False or bytes_x > 2e9:
        return False
    if dense_gram is None:
        if nnz < _AUTO_MIN_NNZ:
            return False
        dense_t = 2.0 * bytes_x / _HBM_BPS
        gather_t = 2.0 * nnz * _SPMM_S_PER_NNZ
        return dense_t < 0.7 * gather_t
    return True


def build_dense_pair(idx: np.ndarray, centered: np.ndarray,
                     shape: Sequence[int], dtype,
                     perm: Optional[Sequence[int]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize (M, W) as flat 2-D [shape[p0], prod(rest)] numpy arrays.

    ``perm`` reorders the relation's modes first (used for middle-mode
    copies: focus mode leading, partners in original order after it).
    Duplicated index tuples accumulate (matches per-observation semantics).
    """
    dims_src = [int(s) for s in shape]
    dims = ([dims_src[p] for p in perm] if perm is not None else dims_src)
    total = int(np.prod(dims, dtype=np.int64))
    # accumulate straight into the storage dtype (f32 covers exact 0/1
    # counts and half-step rating sums; avoids a 2x f64 host transient on
    # GB-scale relations)
    acc = np.float64 if np.dtype(dtype) == np.float64 else np.float32
    n0 = dims[0]
    if acc is np.float32:
        pair = _accum_dense_pair_native(idx, centered, dims, perm, total)
        if pair is not None:
            M, W = pair
            return M.reshape(n0, -1), W.reshape(n0, -1)
    if perm is not None:
        idx = idx[:, list(perm)]
    lin = np.zeros(idx.shape[0], np.int64)
    for d in range(idx.shape[1]):
        lin = lin * dims[d] + idx[:, d].astype(np.int64)
    M = np.zeros(total, acc)
    np.add.at(M, lin, acc(1.0))
    W = np.zeros(total, acc)
    np.add.at(W, lin, np.asarray(centered, acc))
    return M.reshape(n0, -1), W.reshape(n0, -1)


def _accum_dense_pair_native(idx, centered, dims, perm, total):
    """Sorted one-pass C++ accumulation (bdf_accum_dense_pair) — bitwise
    identical to the np.add.at fallback: a STABLE argsort keeps each
    cell's addend order equal to observation order while making the
    GB-scale writes sequential.  The C loop is ~0.3 s at ML-10M once
    pages are resident (+ ~4 s numpy prep); total wall is dominated by
    first-touch page faults of the fresh pair (environment-dependent,
    2-20 s in this sandbox) — still 2-10x under np.add.at's 35-65 s
    random-order scatter.  None when the library is unavailable."""
    import ctypes

    from .. import native
    L = native.lib()
    if L is None or idx.shape[0] == 0:
        return None
    if perm is not None:
        idx = idx[:, list(perm)]
    lin = np.zeros(idx.shape[0], np.int64)
    for d in range(idx.shape[1]):
        lin = lin * dims[d] + idx[:, d].astype(np.int64)
    order = np.argsort(lin, kind="stable")
    lin_s = np.ascontiguousarray(lin[order])
    cen_s = np.ascontiguousarray(
        np.asarray(centered, np.float64)[order])
    M = np.zeros(total, np.float32)
    W = np.zeros(total, np.float32)
    rc = L.bdf_accum_dense_pair(
        idx.shape[0],
        lin_s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cen_s.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        total,
        M.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        W.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    return M, W


def fused_pair_encode(idx: np.ndarray, vals: np.ndarray,
                      shape: Sequence[int]):
    """Layout-invariant eligibility + encoding for the SINGLE-ARRAY fused
    dense path (the sparse-regime answer: relations whose int8 M/W PAIR
    exceeds HBM, e.g. Netflix-shaped 480k x 18k / 100M nnz = 17 GB pair).

    Finds ``(scale s, shift m)`` such that every observed value satisfies
    ``v == s * (e + m)`` with ``e`` a NONZERO int8 — then one stored int8
    array V8 (e at observed cells, 0 elsewhere) yields BOTH dense-matmul
    quantities with the mask derived on the fly:

        P  = (V8 != 0) @ Ypack                      (observation mask)
        b  = s * (V8 @ Z) + (s*m - mean) * ((V8 != 0) @ Z)

    so the Gramian runs as a matmul with HALF the int8 pair's device
    footprint and NO value quantization error (the encoding is exact or
    the path is declined).  Applies to rating-style grids (MovieLens/
    Netflix 1..5, binary 0/1, pIC50 on a reporting grid); continuous
    values or duplicate (i,j) observations return None.

    The STRICT form: every observation must be representable (no
    residual).  :func:`fused_pair_plan` is the general planner (hybrid
    residual, bounded-error grids); this wrapper keeps the historical
    all-or-nothing contract.

    Decided from the observation index + values alone so the single-device
    and sharded engines always agree (same invariant as int8_pair_ok).
    Returns ``(s, m)`` or None.
    """
    plan = fused_pair_plan(idx, vals, shape, tol=None)
    if plan is None or not plan[2].all():
        return None
    return plan[0], plan[1]


def fused_pair_plan(idx: np.ndarray, vals: np.ndarray,
                    shape: Sequence[int], tol: Optional[float] = None):
    """General planner for the single-array fused dense path (the
    fused-INELIGIBLE sparse-regime answer, VERDICT r3 #2).

    Extends :func:`fused_pair_encode` with two relaxations, each under an
    explicit contract:

    - **Hybrid residual (exact math).**  (P_i, b_i) are SUMS over
      observations, so the observation multiset may be split: at most one
      encodable observation per (i, j) cell goes into V8; everything
      else — duplicate observations, and observations whose grid level
      equals the shift ``m`` (their code would be the 0 = unobserved
      sentinel) — rides the bucketed GATHER path with exact values.  The
      two paths' contributions add, so the hybrid is mathematically
      identical to one-path accumulation.
    - **Bounded-error grid (``tol``, opt-in).**  Values with no exact
      <=255-level grid are rounded onto the finest uniform grid whose
      span fits the int8 code range; the path is DECLINED unless the
      grid's max rounding error ``s/2 <= tol``.  The error enters only
      the latent conditional's rhs b (linearly, bounded by
      ``tol * sqrt(deg_i)`` per row before the P^-1 solve); alpha
      sampling and prediction keep exact values.  ``tol=None`` (default)
      admits exact grids only.

    Returns ``None`` or ``(s, m, keep)`` where ``keep`` is a bool mask
    over observations (True -> encoded in V8; ``keep.all()`` when no
    residual is needed).  Decided from (idx, vals, shape, tol) alone, so
    the single-device and sharded engines always agree (the engine-parity
    invariant).
    """
    if idx.shape[1] != 2 or idx.shape[0] == 0:
        return None
    v64 = np.asarray(vals, np.float64)
    d = np.unique(v64)
    s = None
    if d.size <= 255:
        # exact grid: every value an integer multiple of the step,
        # reconstructing to f64 roundoff (same rule as the strict form)
        se = float(np.min(np.diff(d))) if d.size > 1 else (
            abs(float(d[0])) if d[0] != 0 else 1.0)
        if np.isfinite(se) and se > 0:
            q = d / se
            qd = np.rint(q)
            if (np.max(np.abs(q - qd)) <= 1e-9
                    and np.max(np.abs(qd * se - d))
                    <= 1e-9 * max(1.0, float(np.abs(d).max()))
                    and qd.max() - qd.min() <= 254):
                s = se
    if s is None:
        if tol is None or not np.isfinite(tol) or tol <= 0:
            return None
        # Uniform grids, finest first: the finest in-tol grid minimizes
        # rounding error but its feasible shift window (|e| <= 127 from
        # BOTH ends) sits at the level-range CENTER — usually the
        # DENSEST region of real data, so its zero-code residual can be
        # large (netflix_cont: the 3-star peak, ~500k observations whose
        # gather machinery pushed the engine past HBM).  Coarser in-tol
        # grids widen the window; the first one with an UNUSED feasible
        # level gets a ZERO residual.  Candidates are decided from
        # (vals, tol) alone — engine-invariant.
        rng_v = float(d[-1] - d[0])
        if rng_v <= 0:
            s = abs(float(d[0])) if d[0] != 0 else 1.0
            if s / 2.0 > tol:
                return None
        else:
            l_min = max(2, int(np.ceil(rng_v / (2.0 * tol))))
            if l_min > 253:
                return None
            cand = sorted({max(l_min, int(253 * f))
                           for f in (1.0, 0.97, 0.93, 0.88, 0.82, 0.75,
                                     0.65, 0.5, 0.35, 0.2)},
                          reverse=True)
            cand = [L for L in cand if L >= l_min]
            s = rng_v / cand[0]
            for L in cand:
                sc = rng_v / L
                qc = np.rint(d / sc).astype(np.int64)
                lo_c, hi_c = int(qc.min()), int(qc.max())
                if hi_c - lo_c > 254:
                    continue
                w_lo, w_hi = hi_c - 127, lo_c + 127
                if w_lo > w_hi:
                    continue
                window = np.arange(w_lo, w_hi + 1)
                free = window[~np.isin(window, qc)]
                if free.size:
                    s = sc
                    break
    qi = np.rint(d / s).astype(np.int64)
    lo, hi = int(qi.min()), int(qi.max())
    if hi - lo > 254:
        return None
    used = set(int(x) for x in qi)
    # shift search: prefer an UNUSED level (no zero-code residual, the
    # historical behavior bit-for-bit), then minimal |e| range
    best_free, best_used = None, None
    for m in range(lo - 1, hi + 2):
        emax = max(abs(lo - m), abs(hi - m))
        if emax > 127:
            continue
        if m in used:
            if best_used is None or emax < best_used[1]:
                best_used = (m, emax)
        elif best_free is None or emax < best_free[1]:
            best_free = (m, emax)
    if best_free is None and best_used is not None:
        # every feasible level is occupied: minimize the RESIDUAL (the
        # observation count at the zero-code level), not |e| range —
        # ties break to the lowest m (argmin), deterministically
        w_lo, w_hi = max(hi - 127, lo), min(lo + 127, hi)
        full = np.bincount(np.rint(v64 / s).astype(np.int64) - lo,
                           minlength=hi - lo + 1)
        counts = full[w_lo - lo:w_hi - lo + 1]
        best_used = (w_lo + int(np.argmin(counts)), 0)
    best = best_free if best_free is not None else best_used
    if best is None:
        return None
    m = best[0]
    # keep mask: the first encodable observation per linear cell; the
    # rest (duplicates, zero-code level) are the gather residual
    q_obs = np.rint(v64 / s).astype(np.int64)
    encodable = q_obs != m
    keep = np.zeros(idx.shape[0], bool)
    pos = np.nonzero(encodable)[0]
    if pos.size:
        lin = (idx[pos, 0].astype(np.int64) * int(shape[1])
               + idx[pos, 1])
        _, first = np.unique(lin, return_index=True)
        keep[pos[first]] = True
    if not keep.any():
        return None
    return float(s), int(m), keep


def encode_fused_values(vals: np.ndarray, s: float, m: int) -> np.ndarray:
    """int8 codes for :func:`fused_pair_encode`'s (s, m)."""
    return (np.rint(np.asarray(vals, np.float64) / s) - m).astype(np.int8)


def build_fused_values(idx: np.ndarray, vals: np.ndarray,
                       shape: Sequence[int], s: float, m: int) -> np.ndarray:
    """Materialize the single int8 value matrix V8 [shape[0], shape[1]].

    Direct assignment (fused_pair_encode guarantees no duplicates)."""
    n0, n1 = int(shape[0]), int(shape[1])
    lin = idx[:, 0].astype(np.int64) * n1 + idx[:, 1]
    V = np.zeros(n0 * n1, np.int8)
    V[lin] = encode_fused_values(vals, s, m)
    return V.reshape(n0, n1)


_SCATTER_CHUNK_NNZ = 3_000_000


def build_fused_values_device(idx: np.ndarray, vals: np.ndarray,
                              shape: Sequence[int], s: float, m: int):
    """Device-side V8 build: ship the COO (~9 bytes/nnz) and scatter on
    the device, instead of building and uploading the dense array (8.5 GB
    at Netflix scale, against ~0.9 GB of COO).

    The scatter runs over ROW CHUNKS into one donated buffer: each chunk
    bounds the host-side staging and index transient, and every chunk
    reuses ONE compiled scatter program."""
    n0, n1 = int(shape[0]), int(shape[1])
    e = encode_fused_values(vals, s, m)
    nnz = idx.shape[0]
    # ~3M-nnz chunks, a few dozen dispatches.  Every chunk scatters INTO
    # one donated buffer (a concatenate of chunk slabs would transiently
    # hold 2x the array).
    n_chunks = max(1, -(-nnz // _SCATTER_CHUNK_NNZ))
    cap = -(-nnz // n_chunks)

    @partial(jax.jit, donate_argnums=(0,))
    def scatter_chunk(V, r, c, ed):
        return V.at[r, c].set(ed, mode="drop")

    V = jnp.zeros((n0, n1), jnp.int8)
    for ci in range(n_chunks):
        lo = ci * cap
        hi = min(lo + cap, nnz)
        r = np.full(cap, n0, np.int32)          # OOB row -> dropped
        c = np.zeros(cap, np.int32)
        ee = np.zeros(cap, np.int8)
        r[:hi - lo] = idx[lo:hi, 0].astype(np.int32)
        c[:hi - lo] = idx[lo:hi, 1].astype(np.int32)
        ee[:hi - lo] = e[lo:hi]
        V = scatter_chunk(V, jnp.asarray(r), jnp.asarray(c),
                          jnp.asarray(ee))
    return V


def fused_gram_contrib(
    V8: jax.Array,                 # [n0, n1] int8 (0 = unobserved)
    partner: jax.Array,            # [N_partner, K] partner factors
    focus_axis: int,               # 0 or 1 (arity 2 only)
    out_dtype,
    op_dtype,
    scale: float,
    shift: int,
    mean: float,
    row_chunks: int = 32,
) -> Tuple[jax.Array, jax.Array]:
    """One mode's Gramian/rhs from the single fused int8 array:
    P [n_focus, K, K] and the already-centered
    ``b = s*(V8 @ Z) + (s*shift - mean)*(M @ Z)`` [n_focus, K].

    The mask/value operands are derived IN CHUNKS inside a ``fori_loop``:
    an unchunked einsum would materialize the full op_dtype mask (2x the
    stored bytes for bf16)."""
    K = partner.shape[-1]
    iu, ju, expand = _tri_maps(K)
    U = partner.astype(op_dtype)
    Y = U[:, iu] * U[:, ju]                     # [Npartner, C]
    YZ = jnp.concatenate([Y, U], axis=1)        # [Npartner, C + K]
    C = Y.shape[1]
    n0, n1 = V8.shape
    n_focus = V8.shape[focus_axis]
    c1 = jnp.asarray(scale, out_dtype)
    c0 = jnp.asarray(scale * shift - mean, out_dtype)

    # chunk the n0 axis: ceil-sized full chunks via fori_loop plus one
    # statically-sized tail (n0 need not divide; a divisor search would
    # degrade to ONE chunk — i.e. a fully materialized mask — on awkward
    # row counts)
    chunks = max(1, min(row_chunks, n0))
    cn = -(-n0 // chunks)
    full = n0 // cn
    rem = n0 - full * cn

    if focus_axis == 0:
        # focus = rows of V8: chunk over OUTPUT rows, partner = axis 1
        def step(start, size, acc):
            p_acc, pm_acc, bv_acc = acc
            wb = jax.lax.dynamic_slice_in_dim(V8, start, size, 0)
            msk = (wb != 0).astype(op_dtype)
            w = wb.astype(op_dtype)
            pm = jnp.einsum("ab,bz->az", msk, YZ,
                            preferred_element_type=out_dtype)
            bv = jnp.einsum("ab,bz->az", w, U,
                            preferred_element_type=out_dtype)
            return (jax.lax.dynamic_update_slice_in_dim(
                        p_acc, pm[:, :C], start, 0),
                    jax.lax.dynamic_update_slice_in_dim(
                        pm_acc, pm[:, C:], start, 0),
                    jax.lax.dynamic_update_slice_in_dim(
                        bv_acc, bv, start, 0))
    else:
        # focus = cols of V8: chunk over the CONTRACTION rows, accumulate
        dn = (((0,), (0,)), ((), ()))

        def step(start, size, acc):
            p_acc, pm_acc, bv_acc = acc
            wb = jax.lax.dynamic_slice_in_dim(V8, start, size, 0)
            yzb = jax.lax.dynamic_slice_in_dim(YZ, start, size, 0)
            ub = jax.lax.dynamic_slice_in_dim(U, start, size, 0)
            msk = (wb != 0).astype(op_dtype)
            w = wb.astype(op_dtype)
            pm = jax.lax.dot_general(msk, yzb, dn,
                                     preferred_element_type=out_dtype)
            bv = jax.lax.dot_general(w, ub, dn,
                                     preferred_element_type=out_dtype)
            return (p_acc + pm[:, :C], pm_acc + pm[:, C:], bv_acc + bv)

    acc = (jnp.zeros((n_focus, C), out_dtype),
           jnp.zeros((n_focus, K), out_dtype),
           jnp.zeros((n_focus, K), out_dtype))
    if full:
        acc = jax.lax.fori_loop(
            0, full, lambda i, a: step(i * cn, cn, a), acc)
    if rem:
        acc = step(full * cn, rem, acc)
    Pt, bm, bv = acc
    b = c1 * bv + c0 * bm
    P = jnp.take(Pt, jnp.asarray(expand), axis=1)
    return P.reshape(n_focus, K, K), b


def fused_code_bound(vals: np.ndarray, s: float, m: int) -> int:
    """max |e| over the stored int8 codes of :func:`fused_pair_encode`."""
    if len(vals) == 0:
        return 1
    e = np.rint(np.asarray(vals, np.float64) / s) - m
    return int(np.max(np.abs(e)))


def fused_int8_ok(emax: int, shape: Sequence[int],
                  idx: Optional[np.ndarray] = None,
                  abs_codes: Optional[np.ndarray] = None) -> bool:
    """int32-overflow eligibility for the fused s8 path.

    Both dots accumulate in exact int32.  One output element sums over a
    single observed FIBER: ``BV[i, c] = sum_p e_(i,p) * z8_(p,c)`` with
    ``|z8| <= 127``, so with ``(idx, abs_codes)`` given the EXACT bound is
    ``127 * max_axis(bincount(idx[:, axis], weights=|e|))`` — the mask
    dot PM is covered too (``|e| >= 1`` at observed cells).  Both axes
    are checked (each mode contracts one); the bincount maxima are
    permutation-invariant, so the single-device and sharded engines
    always agree regardless of layout (the engine-parity invariant), and
    pad cells are exact zeros.

    Without the observation data it falls back to the dense worst case
    ``127 * emax * (max(shape) + slack)`` — every fiber cell observed at
    the max code — which wrongly declines Netflix-scale continuous grids
    (emax ~127) that the exact per-fiber bound admits by ~40x."""
    if idx is not None and abs_codes is not None and idx.shape[0]:
        worst = 1.0
        for ax in range(idx.shape[1]):
            worst = max(worst, float(np.bincount(
                idx[:, ax], weights=np.asarray(abs_codes, np.float64))
                .max()))
        return 127.0 * worst < 2.0 ** 31 * 0.95
    n_c = max(int(d) for d in shape) + 8192
    return 127.0 * max(emax, 1) * n_c < 2.0 ** 31 * 0.95


def fused_abs_codes(vals: np.ndarray, s: float, m: int) -> np.ndarray:
    """|e| over the stored int8 codes (weights for the per-fiber bound)."""
    return np.abs(np.rint(np.asarray(vals, np.float64) / s) - m)


def fused_quantize(partner: jax.Array, n_valid: Optional[int] = None):
    """Per-sweep int8 quantization of the fused path's partner operands.

    Mirrors the pair path's scheme (:func:`_quantize_cols`: per-OUTPUT-
    column symmetric scales, exact int32 contraction, one broadcast
    dequant multiply).  Returns ``(YZ8 [N, C+K] int8, Z8 [N, K] int8,
    s_yz [C+K] f32, s_z [K] f32)`` where the first C columns are the
    packed-triangle products and the trailing K are the raw factors
    (``Z8`` is that same quantized block, re-issued for the value dot).

    Column-max scales are permutation-invariant over the row set, so the
    sharded engine's permuted-layout tables quantize to row-permuted but
    otherwise BITWISE-identical operands (``n_valid`` excludes pad rows,
    whose latents are prior draws)."""
    K = partner.shape[-1]
    iu, ju, _ = _tri_maps(K)
    Uf = partner.astype(jnp.float32)
    Y8, sY = _quantize_cols(Uf[:, iu] * Uf[:, ju], n_valid)
    U8, sU = _quantize_cols(Uf, n_valid)
    return (jnp.concatenate([Y8, U8], axis=1), U8,
            jnp.concatenate([sY, sU]), sU)


def fused_pair_contract_i8(V8: jax.Array, YZ8: jax.Array, Z8: jax.Array,
                           focus_axis: int, row_chunks: int = 32):
    """Raw fused contraction on int8 operands: EXACT int32
    ``PM = (V8 != 0) @ YZ8`` and ``BV = V8 @ Z8`` in the [n_focus, .]
    layout.  The int32 sums stay raw so the sharded engine can psum them
    EXACTLY before dequantizing: integer addition is associative, so any
    chunking and any cross-device partial-sum order give bitwise-identical
    totals."""
    n0, n1 = V8.shape
    ck, k = YZ8.shape[1], Z8.shape[1]
    chunks = max(1, min(row_chunks, n0))
    cn = -(-n0 // chunks)
    full = n0 // cn
    rem = n0 - full * cn
    if focus_axis == 0:
        def step(start, size, acc):
            pm_acc, bv_acc = acc
            wb = jax.lax.dynamic_slice_in_dim(V8, start, size, 0)
            m8 = (wb != 0).astype(jnp.int8)
            pm = jnp.dot(m8, YZ8, preferred_element_type=jnp.int32)
            bv = jnp.dot(wb, Z8, preferred_element_type=jnp.int32)
            return (jax.lax.dynamic_update_slice_in_dim(pm_acc, pm,
                                                        start, 0),
                    jax.lax.dynamic_update_slice_in_dim(bv_acc, bv,
                                                        start, 0))

        acc = (jnp.zeros((n0, ck), jnp.int32),
               jnp.zeros((n0, k), jnp.int32))
    else:
        dn = (((0,), (0,)), ((), ()))

        def step(start, size, acc):
            pm_acc, bv_acc = acc
            wb = jax.lax.dynamic_slice_in_dim(V8, start, size, 0)
            yzb = jax.lax.dynamic_slice_in_dim(YZ8, start, size, 0)
            zb = jax.lax.dynamic_slice_in_dim(Z8, start, size, 0)
            m8 = (wb != 0).astype(jnp.int8)
            pm = jax.lax.dot_general(m8, yzb, dn,
                                     preferred_element_type=jnp.int32)
            bv = jax.lax.dot_general(wb, zb, dn,
                                     preferred_element_type=jnp.int32)
            return (pm_acc + pm, bv_acc + bv)

        acc = (jnp.zeros((n1, ck), jnp.int32),
               jnp.zeros((n1, k), jnp.int32))
    if full:
        acc = jax.lax.fori_loop(
            0, full, lambda i, a: step(i * cn, cn, a), acc)
    if rem:
        acc = step(full * cn, rem, acc)
    return acc


def fused_finish_i8(PM: jax.Array, BV: jax.Array, s_yz: jax.Array,
                    s_z: jax.Array, K: int, out_dtype,
                    scale: float, shift: int, mean: float,
                    ridge_deg: Optional[jax.Array] = None,
                    alpha=None):
    """Dequantize + center the raw int32 sums into (P [n, K, K], b [n, K]).

    Applies the fused b identity ``b = s*(V8@Z) + (s*shift - mean)*(M@Z)``
    on the dequantized blocks, and the same PD safety ridge as the pair
    path (ops/dense_gram.dense_gram_contrib: ~1.7 sigma of per-row
    spectral quantization noise on the diagonal — load-bearing for long
    chains, r2s5 forensics).

    ``alpha`` folds the relation precision into the dequant scales — one
    multiply instead of a separate alpha pass downstream; the caller must
    not scale again."""
    iu, ju, expand = _tri_maps(K)
    if alpha is not None:
        # fold into the per-column dequant scales ONLY: b is built from
        # the already-scaled BVf/PMf blocks, so c1/c0 must stay unfolded
        # (folding both would square alpha on b); the ridge step tracks
        # mean(s_yz) and inherits the fold automatically
        af = jnp.asarray(alpha, jnp.float32)
        s_yz = s_yz.astype(jnp.float32) * af
        s_z = s_z.astype(jnp.float32) * af
    c1 = jnp.asarray(scale, out_dtype)
    c0 = jnp.asarray(scale * shift - mean, out_dtype)
    C = PM.shape[1] - K
    nf = PM.shape[0]
    PMf = PM.astype(out_dtype) * s_yz.astype(out_dtype)
    BVf = BV.astype(out_dtype) * s_z.astype(out_dtype)
    Pt = PMf[:, :C]
    b = c1 * BVf + c0 * PMf[:, C:]
    if ridge_deg is not None:
        dc = jnp.asarray(np.nonzero(iu == ju)[0])
        step = jnp.mean(s_yz[:C]) * (0.5 * float(np.sqrt(K)))
        rdeg = jnp.sqrt(ridge_deg.astype(jnp.float32))
        Pt = Pt.at[:, dc].add((rdeg[:, None] * step).astype(out_dtype))
    P = jnp.take(Pt, jnp.asarray(expand), axis=1)
    return P.reshape(nf, K, K), b


def fused_gram_contrib_i8(
    V8: jax.Array, partner: jax.Array, focus_axis: int, out_dtype,
    scale: float, shift: int, mean: float,
    n_valid: Optional[int] = None,
    ridge_deg: Optional[jax.Array] = None,
    alpha: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """s8 variant of :func:`fused_gram_contrib` (same outputs): per-sweep
    quantized partner operands, exact int32 contraction, per-column
    dequantization.  Eligibility (:func:`fused_int8_ok`) is the caller's
    contract.  With ``alpha`` given the output is pre-scaled by it (see
    :func:`fused_finish_i8`)."""
    YZ8, Z8, s_yz, s_z = fused_quantize(partner, n_valid)
    PM, BV = fused_pair_contract_i8(V8, YZ8, Z8, focus_axis)
    # f64 seams multiply by alpha in out_dtype afterwards, so the parity
    # reduction order stays at f64 scale
    f64 = jnp.dtype(out_dtype) == jnp.float64
    P_out, b_out = fused_finish_i8(
        PM, BV, s_yz, s_z, partner.shape[-1],
        out_dtype, scale, shift, mean, ridge_deg=ridge_deg,
        alpha=(None if f64 else alpha))
    if alpha is not None and f64:
        P_out = alpha * P_out
        b_out = alpha * b_out
    return P_out, b_out


def int8_pair_ok(idx: np.ndarray, shape: Sequence[int]) -> bool:
    """Layout-INVARIANT int8 eligibility for one relation.

    Both engines must make the SAME engage/decline decision or their
    quantizations diverge (the single-device engine checks one canonical
    pair per relation; the sharded engine one permuted pair per mode — a
    guard computed from the stored 2-D layout's row/col sums gave
    different answers per layout and broke the sharded==plain 1e-8
    invariant).  Computed from the observation index alone:

    - every M count (duplicate multiplicity) must fit int8, and
    - for every mode, the int8 dot contracts ONLY the largest-partner
      axis (matching dense_gram_contrib's choice by true counts), so the
      int32 accumulator bound 127*127*fiber_count applies to fibers
      along that axis — the max multiplicity of idx with that column
      dropped."""
    arity = idx.shape[1]
    dims = [int(s) for s in shape]

    def max_mult(cols):
        if not cols:
            return idx.shape[0]
        lin = np.zeros(idx.shape[0], np.int64)
        for d in cols:
            lin = lin * dims[d] + idx[:, d].astype(np.int64)
        if lin.size == 0:
            return 0
        _, c = np.unique(lin, return_counts=True)
        return int(c.max())

    if max_mult(list(range(arity))) > 127:
        return False
    deg_cap = (2**31) / (127.0 * 127.0)
    for mode in range(arity):
        parts = [d for d in range(arity) if d != mode]
        big = parts[int(np.argmax([dims[d] for d in parts]))]
        if max_mult([d for d in range(arity) if d != big]) >= deg_cap:
            return False
    return True


def quantize_dense_pair(M: np.ndarray, W: np.ndarray):
    """int8-quantize a dense (M, W) pair for the s8 path.

    M holds exact small observation counts (0/1 plus duplicates) — stored
    verbatim in int8.  W holds the centered-value sums; it is symmetric-
    quantized with ONE static per-relation scale ``w_scale`` so the
    dequantization after the dot is a single broadcast multiply.
    Eligibility (counts fit int8; the exact-int32 dots cannot overflow)
    is decided beforehand by :func:`int8_pair_ok` — from the observation
    index, NOT this stored layout, so both engines decide identically.

    Precision: W's quantization step is ``max|W|/127`` — for rating-scale
    values that is ~0.8% of the max, the same order as bf16's 2^-9
    element-wise rounding that the default ``gram_dtype='bfloat16'`` path
    already accepts (int8 probe + RMSE-parity run in the project's round-2
    notes; tests/test_longchain.py gates it now).
    """
    assert float(M.max(initial=0.0)) <= 127.0, "int8_pair_ok not consulted"
    if M.dtype == np.float32 and W.dtype == np.float32:
        q = _quantize_pair_native(M, W)
        if q is not None:
            return q
    w_max = float(np.abs(W).max(initial=0.0))
    w_scale = (w_max / 127.0) or 1.0
    M8 = M.astype(np.int8)
    # DESTRUCTIVE: W is quantized in place — the out-of-place chain
    # allocated 4 GB-scale temporaries (53 s + swap pressure at ML-10M
    # size).  Callers must treat W as consumed; in particular do NOT
    # jnp.asarray(W) before this call — on the CPU backend that is a
    # ZERO-COPY alias and the mutation races the async device computation.
    np.divide(W, w_scale, out=W)
    np.rint(W, out=W)
    np.clip(W, -127, 127, out=W)
    W8 = W.astype(np.int8)
    return M8, W8, w_scale


def _quantize_pair_native(M, W):
    """C++ two-pass quantize (native/layout.cpp bdf_quantize_pair) —
    bitwise identical to the NumPy path (f32 divide, round-half-even,
    clip, cast); leaves W intact.  None when the library is missing."""
    import ctypes

    from .. import native
    L = native.lib()
    if L is None:
        return None
    Mc = np.ascontiguousarray(M.reshape(-1))
    Wc = np.ascontiguousarray(W.reshape(-1))
    M8 = np.empty(Mc.shape[0], np.int8)
    W8 = np.empty(Wc.shape[0], np.int8)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    p_i8 = ctypes.POINTER(ctypes.c_int8)
    w_scale = L.bdf_quantize_pair(Mc.shape[0],
                                  Mc.ctypes.data_as(p_f32),
                                  Wc.ctypes.data_as(p_f32),
                                  M8.ctypes.data_as(p_i8),
                                  W8.ctypes.data_as(p_i8))
    return (M8.reshape(M.shape), W8.reshape(W.shape), float(w_scale))


# shared scale constant: an explicit MULTIPLY by the f32 reciprocal —
# XLA rewrites a divide-by-constant to a reciprocal multiply only in some
# graphs; the multiply form is rewrite-proof and identical everywhere
_INV127 = np.float32(1.0 / 127.0)


def _quantize_cols(A: jax.Array, n_valid: Optional[int] = None):
    """Per-output-column symmetric int8 quantization (traced, per sweep).

    The scale vector multiplies the dot's OUTPUT columns, so dequantization
    is exact per column: ``dot(M8, round(A/s)) * s == dot(M8, A)`` up to
    the rounding of A alone — the contraction itself is exact integer
    arithmetic.

    ``n_valid``: compute the scales over this leading (static) row prefix
    only — the sharded engine's padded factor tables carry trailing pad
    rows whose latents are prior draws; excluding them keeps the scales
    (and thus the quantized values and the exact-int32 dots) bitwise equal
    to the single-device engine's."""
    Av = A if n_valid is None else A[:n_valid]
    s = _floor_scale(jnp.max(jnp.abs(Av), axis=0) * _INV127, A.dtype)
    return _q8(A, s), s


def _floor_scale(s: jax.Array, dtype) -> jax.Array:
    return jnp.maximum(s, jnp.asarray(np.finfo(np.float32).tiny, dtype))


def _q8(A: jax.Array, s: jax.Array) -> jax.Array:
    """Symmetric int8 quantization of A against per-column scales s — the
    ONE copy of the load-bearing round/clip convention (both the exact and
    the bounded scale paths must quantize identically or the Pt and b dots
    diverge between engines)."""
    return jnp.clip(jnp.round(A / s), -127.0, 127.0).astype(jnp.int8)


_tri_cache = {}


def _tri_maps(K: int):
    """(iu, ju, expand) for symmetric packing: Y needs only the K(K+1)/2
    upper-triangle products (P is symmetric — ~48% of the matmul FLOPs
    are redundant); ``expand`` maps flat [K*K] positions back into the
    packed triangle."""
    if K not in _tri_cache:
        iu, ju = np.triu_indices(K)
        tri_of = np.zeros((K, K), np.int32)
        tri_of[iu, ju] = np.arange(len(iu), dtype=np.int32)
        tri_of = np.maximum(tri_of, tri_of.T)  # symmetric lookup
        _tri_cache[K] = (iu.astype(np.int32), ju.astype(np.int32),
                         tri_of.reshape(-1))
    return _tri_cache[K]


def dense_gram_contrib(
    M: jax.Array,            # flat dense mask, reshapeable to `dims`
    W: jax.Array,            # flat dense centered values, same layout
    partner_factors: Sequence[jax.Array],  # [N_d, K] per non-focus axis,
                                           # in the axis order of `dims`
    focus_axis: int,
    dims: Sequence[int],
    out_dtype,
    op_dtype,
    w_scale: Optional[float] = None,
    n_valid: Optional[Sequence[Optional[int]]] = None,
    ridge_deg: Optional[jax.Array] = None,  # static [n_focus] observation
                                            # counts (int8 PD ridge)
    alpha=None,                  # fold the relation precision into the
                                 # dequant scales (s8 path) / output
                                 # (float path): the caller must NOT
                                 # multiply by alpha again
) -> Tuple[jax.Array, jax.Array]:
    """One mode's Gramian/rhs contribution: P [n_focus, K, K],
    b [n_focus, K] (scaled by ``alpha`` when given).

    One multi-operand einsum per quantity: ``P = einsum(T, Y_d...)`` with
    per-partner packed-triangle tables Y_d = U_d[:,iu] * U_d[:,ju]
    (the Hadamard context factorizes: (z o w)(z o w)^T = zz^T o ww^T, and
    the packed triangle commutes with the Hadamard).  opt_einsum's path
    contracts the big axes first, so tensor modes never materialize a
    [prod N_d, K^2] table and every mode shares the canonical array.
    P_ab == P_ba bit-exactly (commutative products, same accumulation
    order), so packing is exact, not an approximation.
    """
    K = partner_factors[0].shape[-1]
    dims = tuple(int(d) for d in dims)
    n_focus = dims[focus_axis]
    T = M.reshape(dims)
    Wt = W.reshape(dims)
    letters = "abcdefgh"[:len(dims)]
    parts = [d for d in range(len(dims)) if d != focus_axis]
    out_sub = letters[focus_axis] + "z"
    spec = (letters + ","
            + ",".join(letters[d] + "z" for d in parts)
            + "->" + out_sub)
    if w_scale is not None:
        # s8 path: M/W stored int8 (exact counts / statically-scaled
        # values, quantize_dense_pair).  The LARGEST partner axis is
        # contracted first as an s8 x s8 -> exact-int32 dot (the dominant
        # pairwise contraction — all of T/W streams through it), with the
        # per-OUTPUT-COLUMN scales dequantizing in one broadcast multiply;
        # any remaining (small) partner axes finish in f32.  For arity 2
        # this is the whole contraction.
        Uf = [U.astype(jnp.float32) for U in partner_factors]
        nv = (list(n_valid) if n_valid is not None
              else [None] * len(Uf))
        # "largest" judged by TRUE row counts when given (sharded partner
        # dims are padded; plain are not — the choice must agree between
        # engines or their quantizations diverge)
        sizes = [nv[i] if nv[i] is not None else dims[d]
                 for i, d in enumerate(parts)]
        bi = int(np.argmax(sizes))
        big = parts[bi]
        rem = [d for d in range(len(dims)) if d != big]
        rem_str = "".join(letters[d] for d in rem)
        spec_i8 = letters + "," + letters[big] + "z->" + rem_str + "z"
        spec_f32 = (rem_str + "z,"
                    + ",".join(letters[d] + "z" for d in parts if d != big)
                    + "->" + out_sub) if len(dims) > 2 \
            else None

        def contract(T8, big_q, small_tables, extra_scale):
            A8, sa = big_q
            # dequantize and finish in OUT_DTYPE: under f64 the step-2
            # reduction's rounding must stay at f64 scale or the sharded
            # slab's different S layout (hence reduce order) breaks the
            # 1e-8 engine-parity seam
            scale = (extra_scale * sa).astype(out_dtype)
            if alpha is not None:
                # alpha-folded contract (see the signature note)
                scale = scale * jnp.asarray(alpha, out_dtype)
            S = (jnp.einsum(spec_i8, T8, A8,
                            preferred_element_type=jnp.int32)
                 .astype(out_dtype) * scale)
            if spec_f32 is None:
                return S
            # step 2 streams the [rem..., z] intermediate once more — run
            # it at op_dtype (bf16 under gram_dtype="bfloat16", halving
            # the dominant traffic; f64 in the oracle/parity seam,
            # keeping 1e-8 engine parity), accumulate in out_dtype
            small = [t.astype(op_dtype) for t in small_tables]
            return jnp.einsum(spec_f32, S.astype(op_dtype), *small,
                              preferred_element_type=out_dtype)

        iu, ju, expand = _tri_maps(K)
        # EXACT per-column scales for the big packed-triangle table (a
        # bound-product variant was ~2% faster but its ~2x-coarser steps
        # fed the instability below harder — reverted)
        Yq = _quantize_cols(Uf[bi][:, iu] * Uf[bi][:, ju], nv[bi])
        Pt = contract(T, Yq,
                      [U[:, iu] * U[:, ju]
                       for i, U in enumerate(Uf) if i != bi], 1.0)
        # PD SAFETY RIDGE — load-bearing for long chains.  The per-row
        # spectral quantization noise ~ sqrt(deg_i) * step * sqrt(K)
        # rivals lambda_min(P) for weakly-determined rows; without this
        # margin the sampler's occasional wide draws inflate the column
        # maxes, coarsening every row's quantization — a feedback loop
        # that drove BOTH ML-100k (sweep ~92) and ML-10M (sweep ~200) to
        # a non-PD P and NaN (r2s5 forensics: a deg-53 row with exact
        # lambda_min 2.13 quantized to -0.29).  Adding ~1.7 sigma of that
        # noise to the diagonal (a deterministic <~2% precision bias —
        # the same order as the quantization noise itself) keeps P PD;
        # 400-sweep ML-100k / 500-sweep ML-10M runs hold rmse at the
        # bf16 value.  deg is static; mean(s) tracks the live scales.
        if ridge_deg is not None:
            dc = jnp.asarray(np.nonzero(iu == ju)[0])
            step = (jnp.mean(Yq[1]) * (0.5 * float(np.sqrt(K))))
            if alpha is not None:
                step = step * alpha     # track the folded scales
            rdeg = jnp.sqrt(ridge_deg.astype(jnp.float32))
            Pt = Pt.at[:, dc].add((rdeg[:, None] * step)
                                  .astype(out_dtype))
        b = contract(Wt, _quantize_cols(Uf[bi], nv[bi]),
                     [U for i, U in enumerate(Uf) if i != bi], w_scale)
        P = jnp.take(Pt, jnp.asarray(expand), axis=1)
        return P.reshape(n_focus, K, K), b
    Us = [U.astype(op_dtype) for U in partner_factors]
    # Triangle packing trades ~48% of the matmul FLOPs for an extra
    # [n_focus, K^2] expand pass — a win only when the contraction is
    # compute-bound (big relations), a loss on small bandwidth-bound ones.
    total = float(np.prod(dims))
    flop_saving_s = total * K * K / _MATMUL_FLOPS
    expand_cost_s = n_focus * K * K * 6.0 / _HBM_BPS
    if flop_saving_s > 2.0 * expand_cost_s:
        iu, ju, expand = _tri_maps(K)
        Ys = [U[:, iu] * U[:, ju] for U in Us]
        Pt = jnp.einsum(spec, T, *Ys, preferred_element_type=out_dtype)
        P = jnp.take(Pt, jnp.asarray(expand), axis=1)
    else:
        Ys = [(U[:, :, None] * U[:, None, :]).reshape(U.shape[0], K * K)
              for U in Us]
        P = jnp.einsum(spec, T, *Ys, preferred_element_type=out_dtype)
    b = jnp.einsum(spec, Wt, *Us, preferred_element_type=out_dtype)
    if alpha is not None:
        P, b = alpha * P, alpha * b
    return P.reshape(n_focus, K, K), b
