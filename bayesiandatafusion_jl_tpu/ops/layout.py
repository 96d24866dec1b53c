"""Degree-bucketed observation layout (the device replacement for IndexedDF).

The reference gathers each instance's observations through a per-instance
inverted index (``IndexedDF.index[mode][i] -> row ids``; src/IndexedDF.jl
[MED], SURVEY.md §3) — a ragged, pointer-chasing structure.  On the device
we re-layout once at compile time (SURVEY §9.0): for each (relation, mode)
the observations are grouped by instance, degree-sorted, and packed into a
small set of dense blocks ("buckets") of fixed width.  Instances whose
degree exceeds the widest bucket are *chunked* into several rows that
scatter-add into the same accumulator row — this is the skew handling for
head entities (SURVEY §7.7 / §9.2).

Every array here is static-shaped, so the whole Gibbs sweep jit-compiles
once with zero retracing.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Bucket:
    """One fixed-width block of packed observations for a (relation, mode).

    rows r of this bucket contribute to instance ``inst[r]`` of the focus
    mode; ``part[d][r, w]`` indexes the d-th *other* mode's factor matrix
    (other modes in relation order, focus mode excluded).  Padding entries
    have mask 0 / val 0 / part 0 (index 0 is a valid row; its contribution
    is zeroed by the mask so the scatter-add is a no-op).
    """

    width: int
    inst: np.ndarray          # [rows] int32
    part: List[np.ndarray]    # (arity-1) x [rows, width] int32
    val: np.ndarray           # [rows, width] f32/f64 — centered, 0-padded
    mask: np.ndarray          # [rows, width] f32/f64 — 1 for real entries

    @property
    def n_rows(self) -> int:
        return int(self.inst.shape[0])


@dataclasses.dataclass
class ModeLayout:
    """All buckets for one (relation, mode) pair."""

    buckets: List[Bucket]
    n_instances: int
    arity: int
    nnz: int

    @property
    def padded_nnz(self) -> int:
        return sum(b.n_rows * b.width for b in self.buckets)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_mode_layout(
    idx: np.ndarray,           # [nnz, D] int32 observation indices
    centered_vals: np.ndarray, # [nnz] float (v - mean_r)
    mode: int,
    n_instances: int,
    widths: Sequence[int] = (8, 32, 128, 512, 2048),
    row_pad: int = 8,
    dtype=np.float32,
    use_native: bool = True,
) -> ModeLayout:
    """Pack one relation's observations for sampling ``mode``'s entity.

    Dispatches to the C++ builder (native/layout.cpp) when compiled and the
    target dtype is float32 (the production path); otherwise the vectorized
    NumPy implementation below.  Both produce identical layouts (same piece
    order, same CSR observation order) — pinned by tests/test_layout.py.
    """
    if use_native and np.dtype(dtype) == np.float32:
        ml = _build_mode_layout_native(idx, centered_vals, mode,
                                       n_instances, widths, row_pad)
        if ml is not None:
            return ml
    return _build_mode_layout_numpy(idx, centered_vals, mode, n_instances,
                                    widths, row_pad, dtype)


def _build_mode_layout_native(idx, centered_vals, mode, n_instances,
                              widths, row_pad):
    """One-pass C++ layout build via ctypes; None if the lib is missing."""
    import ctypes

    from .. import native
    L = native.lib()
    if L is None:
        return None
    idx = np.ascontiguousarray(idx, np.int32)
    vals = np.ascontiguousarray(centered_vals, np.float64)
    nnz, D = idx.shape
    widths = np.asarray(sorted(set(int(w) for w in widths)), np.int64)
    nw = len(widths)
    deg = np.zeros(n_instances, np.int64)
    ppw = np.zeros(nw, np.int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    p_f64 = ctypes.POINTER(ctypes.c_double)

    def P(a, ty):
        return a.ctypes.data_as(ty)

    total = L.bdf_plan_layout(nnz, D, mode, n_instances, P(idx, p_i32),
                              P(widths, p_i64), nw, P(deg, p_i64),
                              P(ppw, p_i64))
    if total < 0:
        raise ValueError("native layout plan failed (index out of range?)")

    inst_arrs, part_arrs, val_arrs, mask_arrs = [], [], [], []
    for c in range(nw):
        rows = _round_up(int(ppw[c]), row_pad) if ppw[c] else 0
        w = int(widths[c])
        inst_arrs.append(np.zeros(rows, np.int32))
        part_arrs.append([np.zeros((rows, w), np.int32)
                          for _ in range(D - 1)])
        val_arrs.append(np.zeros((rows, w), np.float32))
        mask_arrs.append(np.zeros((rows, w), np.float32))

    inst_ptrs = (p_i32 * nw)(*[P(a, p_i32) for a in inst_arrs])
    part_flat = [p for ps in part_arrs for p in ps]
    part_ptrs = (p_i32 * max(len(part_flat), 1))(
        *[P(a, p_i32) for a in part_flat]) if part_flat else (p_i32 * 1)()
    val_ptrs = (p_f32 * nw)(*[P(a, p_f32) for a in val_arrs])
    mask_ptrs = (p_f32 * nw)(*[P(a, p_f32) for a in mask_arrs])
    rc = L.bdf_fill_layout(nnz, D, mode, n_instances, P(idx, p_i32),
                           P(vals, p_f64), 0.0, P(widths, p_i64), nw,
                           P(deg, p_i64), inst_ptrs, part_ptrs, val_ptrs,
                           mask_ptrs)
    if rc != 0:
        raise ValueError("native layout fill failed")
    buckets = [Bucket(width=int(widths[c]), inst=inst_arrs[c],
                      part=part_arrs[c], val=val_arrs[c],
                      mask=mask_arrs[c])
               for c in range(nw) if ppw[c]]
    return ModeLayout(buckets=buckets, n_instances=n_instances, arity=D,
                      nnz=nnz)


def _build_mode_layout_numpy(
    idx: np.ndarray,
    centered_vals: np.ndarray,
    mode: int,
    n_instances: int,
    widths: Sequence[int],
    row_pad: int,
    dtype,
) -> ModeLayout:
    idx = np.asarray(idx, np.int32)
    nnz, D = idx.shape
    widths = sorted(set(int(w) for w in widths))
    wmax = widths[-1]
    other_modes = [d for d in range(D) if d != mode]

    # CSR-by-instance: stable sort by focus-mode index
    order = np.argsort(idx[:, mode], kind="stable")
    sidx = idx[order]
    svals = np.asarray(centered_vals, np.float64)[order]
    deg = np.bincount(idx[:, mode], minlength=n_instances).astype(np.int64)

    # --- piece generation, fully vectorized ---
    # each instance's run of `deg` observations splits into floor(deg/wmax)
    # full chunks of width wmax plus one remainder chunk (skew handling for
    # head instances, SURVEY §7.7/§9.2)
    n_full = deg // wmax
    rem = deg - n_full * wmax
    n_pieces_per_inst = n_full + (rem > 0)
    total_pieces = int(n_pieces_per_inst.sum())
    if total_pieces == 0:
        return ModeLayout(buckets=[], n_instances=n_instances, arity=D,
                          nnz=nnz)
    piece_inst = np.repeat(np.arange(n_instances, dtype=np.int64),
                           n_pieces_per_inst)
    # length of each piece: wmax for all but possibly the last of each inst
    piece_len = np.full(total_pieces, wmax, np.int64)
    last_piece_of_inst = (np.cumsum(n_pieces_per_inst) - 1)[
        n_pieces_per_inst > 0]
    rem_nz = rem[n_pieces_per_inst > 0]
    piece_len[last_piece_of_inst] = np.where(rem_nz > 0, rem_nz, wmax)
    piece_off = np.concatenate([[0], np.cumsum(piece_len)[:-1]])
    # bucket class: smallest width >= piece length
    warr = np.asarray(widths, np.int64)
    piece_cls = np.searchsorted(warr, piece_len)

    # per-observation: owning piece and position within it
    obs_piece = np.repeat(np.arange(total_pieces), piece_len)
    obs_pos = np.arange(nnz, dtype=np.int64) - piece_off[obs_piece]

    buckets: List[Bucket] = []
    for ci, w in enumerate(widths):
        psel = piece_cls == ci
        n_p = int(psel.sum())
        if n_p == 0:
            continue
        n_rows = _round_up(n_p, row_pad)
        # row index within this bucket for every piece of this class
        row_of_piece = np.full(total_pieces, -1, np.int64)
        row_of_piece[psel] = np.arange(n_p)
        osel = psel[obs_piece]
        r = row_of_piece[obs_piece[osel]]
        c = obs_pos[osel]
        inst = np.zeros(n_rows, np.int32)
        inst[:n_p] = piece_inst[psel]
        part = []
        for d in other_modes:
            a = np.zeros((n_rows, w), np.int32)
            a[r, c] = sidx[osel, d]
            part.append(a)
        val = np.zeros((n_rows, w), dtype)
        val[r, c] = svals[osel]
        mask = np.zeros((n_rows, w), dtype)
        mask[r, c] = 1.0
        buckets.append(Bucket(width=w, inst=inst, part=part, val=val,
                              mask=mask))

    return ModeLayout(buckets=buckets, n_instances=n_instances, arity=D,
                      nnz=nnz)
