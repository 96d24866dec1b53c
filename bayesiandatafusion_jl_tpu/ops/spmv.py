"""Bucketed sparse-binary matvec for the side-information matrix.

The CG link-matrix solve (SURVEY §4.4) is dominated by the matvec
``w = X'(X v) + lambda v`` on the sparse binary feature matrix.  Instead
of plain segment-sums over the whole nnz axis (a scatter per nnz),
re-using the degree-bucketed layout machinery (ops/layout.py) turns each
product into gather + masked einsum + a SMALL row-level segment-sum.

Reference counterpart: ``A_mul_B!`` / ``At_mul_B!`` on SparseBinMatrix
(src/sparsebinmatrix.jl [MED]).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .layout import build_mode_layout


def build_bucketed_matvec(rows: np.ndarray, cols: np.ndarray,
                          shape: Tuple[int, int],
                          vals: np.ndarray = None,
                          widths=(8, 16, 32, 64, 128, 256, 512, 1024, 2048),
                          row_pad: int = 8,
                          dtype=np.float32) -> Dict[str, list]:
    """Host-side build: bucketed layouts for X@V (by-row) and X.T@U
    (by-column) of a COO matrix.

    ``vals=None`` = binary X (all-ones weights — the reference's ECFP
    case); a float array carries real-valued features (SURVEY §3 Entity
    row: ``entity.F`` is an arbitrary sparse matrix, not binary-only).
    The bucket weight ``w`` equals the mask for binary input, so the
    device path is identical either way.
    """
    idx = np.stack([np.asarray(rows, np.int64),
                    np.asarray(cols, np.int64)], axis=1)
    w = np.ones(idx.shape[0]) if vals is None else np.asarray(vals,
                                                              np.float64)
    out = {}
    for key, mode, n in (("fwd", 0, shape[0]), ("t", 1, shape[1])):
        ml = build_mode_layout(idx, w, mode, n, widths=widths,
                               row_pad=row_pad, dtype=dtype)
        out[key] = [{"inst": jnp.asarray(b.inst),
                     "part": jnp.asarray(b.part[0]),
                     "w": jnp.asarray(b.val)} for b in ml.buckets]
    return out


def bucketed_spmm(buckets: Sequence[Dict[str, jax.Array]], n_out: int,
                  v: jax.Array) -> jax.Array:
    """y[i] = sum_j x_ij v[j] for one direction's buckets.

    v: [n_in, K] -> y: [n_out, K].  ``w`` carries the x values (ones for
    binary X) with zero padding, so no separate mask multiply is needed.
    """
    y_rows, inst = [], []
    for ba in buckets:
        z = v.at[ba["part"]].get(mode="promise_in_bounds")  # [rows, W, K]
        y_rows.append(jnp.einsum("rwk,rw->rk", z,
                                 ba["w"].astype(z.dtype)))
        inst.append(ba["inst"])
    if not y_rows:
        return jnp.zeros((n_out, v.shape[1]), v.dtype)
    return jax.ops.segment_sum(jnp.concatenate(y_rows),
                               jnp.concatenate(inst), num_segments=n_out)
