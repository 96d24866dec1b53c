"""Sparse binary feature matrices and their device matvec path.

Reference counterpart: ``SparseBinMatrix`` (Int32 row/col COO arrays with
allocation-free ``A_mul_B!``/``At_mul_B!``) and its worker-distributed
``ParallelSBM`` — src/sparsebinmatrix.jl [MED], SURVEY.md §3/§5.3.

Design: the matvec is a gather + segment-sum over the nnz axis —
``(X v)[i] = sum_{n: row_n = i} v[col_n]`` (binary X means no multiplies).
Rows are kept sorted by row index so XLA can use the sorted-segment path.
The multi-device equivalent of ParallelSBM shards the nnz axis and psums
partial segment sums (see parallel/sharded.py).

Also includes the sparse I/O helpers the reference ships for ECFP feature
files (read/write of row/col index binary files; src/... [LOW]).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class SparseBinMatrix:
    """Sparse feature matrix in COO form (host-side, NumPy int32).

    ``rows``/``cols`` are 0-based int32, sorted lexicographically by
    (row, col).  ``vals=None`` means all-ones (the reference's binary
    ``SparseBinMatrix`` — ECFP fingerprints); a float array gives a
    real-valued sparse matrix (the reference's ``entity.F`` accepts any
    SparseMatrixCSC — SURVEY §3 Entity row, §4.4).
    """

    rows: np.ndarray  # [nnz] int32
    cols: np.ndarray  # [nnz] int32
    shape: Tuple[int, int]
    vals: Optional[np.ndarray] = None  # [nnz] float64, or None = binary

    def __post_init__(self):
        self.rows = np.asarray(self.rows, np.int32)
        self.cols = np.asarray(self.cols, np.int32)
        if self.vals is not None:
            self.vals = np.asarray(self.vals, np.float64).ravel()
            if self.vals.shape[0] != self.rows.shape[0]:
                raise ValueError("vals length != nnz")
        order = np.lexsort((self.cols, self.rows))
        if not np.all(order == np.arange(len(order))):
            self.rows = self.rows[order]
            self.cols = self.cols[order]
            if self.vals is not None:
                self.vals = self.vals[order]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def is_binary(self) -> bool:
        return self.vals is None

    def values(self) -> np.ndarray:
        """Explicit value array (ones when binary)."""
        return (np.ones(self.nnz, np.float64) if self.vals is None
                else self.vals)

    @classmethod
    def from_scipy(cls, m) -> "SparseBinMatrix":
        coo = m.tocoo()
        data = np.asarray(coo.data, np.float64)
        vals = None if np.all(data == 1.0) else data
        return cls(coo.row.astype(np.int32), coo.col.astype(np.int32),
                   (int(coo.shape[0]), int(coo.shape[1])), vals)

    @classmethod
    def from_dense(cls, m: np.ndarray) -> "SparseBinMatrix":
        m = np.asarray(m)
        r, c = np.nonzero(m)
        data = np.asarray(m[r, c], np.float64)
        vals = None if np.all(data == 1.0) else data
        return cls(r.astype(np.int32), c.astype(np.int32), tuple(m.shape),
                   vals)

    def to_dense(self) -> np.ndarray:
        d = np.zeros(self.shape, np.float64)
        d[self.rows, self.cols] = self.values()
        return d

    # -- host-side (NumPy) products, mirroring A_mul_B!/At_mul_B! ------------
    def matmul(self, v: np.ndarray) -> np.ndarray:
        """X @ v  (v: [F] or [F, K])."""
        out = np.zeros((self.shape[0],) + v.shape[1:], v.dtype)
        vc = v[self.cols]
        if self.vals is not None:
            vc = vc * self.vals.reshape((-1,) + (1,) * (v.ndim - 1))
        np.add.at(out, self.rows, vc)
        return out

    def t_matmul(self, v: np.ndarray) -> np.ndarray:
        """X.T @ v  (v: [N] or [N, K])."""
        out = np.zeros((self.shape[1],) + v.shape[1:], v.dtype)
        vr = v[self.rows]
        if self.vals is not None:
            vr = vr * self.vals.reshape((-1,) + (1,) * (v.ndim - 1))
        np.add.at(out, self.cols, vr)
        return out

    def gram(self) -> np.ndarray:
        """Dense X'X (the ``use_FF`` precompute; feasible for small F)."""
        F = self.shape[1]
        g = np.zeros((F, F), np.float64)
        vals = self.values()
        # group by row; accumulate outer products of each row's support
        order = np.argsort(self.rows, kind="stable")
        rows, cols, v = self.rows[order], self.cols[order], vals[order]
        starts = np.searchsorted(rows, np.arange(self.shape[0]))
        ends = np.searchsorted(rows, np.arange(self.shape[0]) + 1)
        for s, e in zip(starts, ends):
            idx = cols[s:e]
            g[np.ix_(idx, idx)] += np.outer(v[s:e], v[s:e])
        return g

    def col_sq_sums(self) -> np.ndarray:
        """diag(X'X) = per-column sum of squared values (Jacobi precond)."""
        if self.vals is None:
            return np.bincount(self.cols, minlength=self.shape[1]).astype(
                np.float64)
        return np.bincount(self.cols, weights=self.vals ** 2,
                           minlength=self.shape[1])


# ---------------------------------------------------------------------------
# Device-side ops (jit-safe): COO arrays live on device as int32.
# ---------------------------------------------------------------------------

def spmm(rows: jax.Array, cols: jax.Array, n_rows: int, v: jax.Array) -> jax.Array:
    """y = X @ v for binary COO X (rows sorted). v: [F, K] -> y: [N, K]."""
    return jax.ops.segment_sum(v[cols], rows, num_segments=n_rows,
                               indices_are_sorted=True)


def spmm_t(rows: jax.Array, cols: jax.Array, n_cols: int, u: jax.Array) -> jax.Array:
    """y = X.T @ u for binary COO X. u: [N, K] -> y: [F, K]."""
    return jax.ops.segment_sum(u[rows], cols, num_segments=n_cols,
                               indices_are_sorted=False)


# ---------------------------------------------------------------------------
# Sparse binary I/O (reference ships .sbm-style row/col index files [LOW]).
# Format here: magic, int64 nrow/ncol/nnz, then int32 rows then int32 cols
# (0-based).  ``read_sparse_float64`` handles an optional float64 value block
# (values are ignored for binary feature use).
# ---------------------------------------------------------------------------

_MAGIC = b"SBM1"


def write_sparse_binary(path: str, m: SparseBinMatrix) -> None:
    from .. import native
    L = native.lib()
    if L is not None:
        import ctypes
        p = ctypes.POINTER(ctypes.c_int32)
        rows = np.ascontiguousarray(m.rows, np.int32)
        cols = np.ascontiguousarray(m.cols, np.int32)
        if L.bdf_write_sbm(path.encode(), m.shape[0], m.shape[1], m.nnz,
                           rows.ctypes.data_as(p),
                           cols.ctypes.data_as(p)) == 0:
            return
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<qqq", m.shape[0], m.shape[1], m.nnz))
        f.write(m.rows.astype("<i4").tobytes())
        f.write(m.cols.astype("<i4").tobytes())


def read_sparse_binary(path: str) -> SparseBinMatrix:
    from .. import native
    L = native.lib()
    if L is not None:
        import ctypes
        shape = np.zeros(2, np.int64)
        p64 = ctypes.POINTER(ctypes.c_int64)
        nnz = L.bdf_read_sbm_header(path.encode(),
                                    shape.ctypes.data_as(p64))
        if nnz < 0:
            raise ValueError(f"{path}: not an SBM1 file")
        rows = np.empty(nnz, np.int32)
        cols = np.empty(nnz, np.int32)
        p32 = ctypes.POINTER(ctypes.c_int32)
        if L.bdf_read_sbm(path.encode(), nnz, rows.ctypes.data_as(p32),
                          cols.ctypes.data_as(p32)) != 0:
            raise ValueError(f"{path}: truncated SBM1 file")
        return SparseBinMatrix(rows, cols, (int(shape[0]), int(shape[1])))
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an SBM1 file")
        nrow, ncol, nnz = struct.unpack("<qqq", f.read(24))
        rows = np.frombuffer(f.read(4 * nnz), "<i4").copy()
        cols = np.frombuffer(f.read(4 * nnz), "<i4").copy()
    return SparseBinMatrix(rows, cols, (int(nrow), int(ncol)))


def read_matrix_market(path: str):
    """Minimal MatrixMarket coordinate reader (the reference README loads
    relation/feature matrices via MatrixMarket [MED]; SURVEY §2 L6).

    Returns (rows, cols, vals, shape) 0-based; pattern matrices get
    vals = 1.0.
    """
    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        parts = header.split()
        if "coordinate" not in parts:
            raise ValueError("only coordinate (sparse) format supported")
        pattern = "pattern" in parts
        symmetric = "symmetric" in parts
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrow, ncol, nnz = (int(x) for x in line.split())
        rows = np.empty(nnz, np.int64)
        cols = np.empty(nnz, np.int64)
        vals = np.ones(nnz, np.float64)
        for i in range(nnz):
            toks = f.readline().split()
            rows[i] = int(toks[0]) - 1
            cols[i] = int(toks[1]) - 1
            if not pattern and len(toks) > 2:
                vals[i] = float(toks[2])
    if symmetric:
        off = rows != cols
        rows = np.concatenate([rows, cols[off]])
        cols = np.concatenate([cols, rows[:nnz][off]])
        vals = np.concatenate([vals, vals[off]])
    return rows, cols, vals, (nrow, ncol)


def write_matrix_market(path: str, rows, cols, vals, shape) -> None:
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{shape[0]} {shape[1]} {len(vals)}\n")
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{int(r) + 1} {int(c) + 1} {v:.17g}\n")


def write_sparse_float64(path: str, rows: np.ndarray, cols: np.ndarray,
                         vals: np.ndarray, shape: Tuple[int, int]) -> None:
    with open(path, "wb") as f:
        f.write(b"SBF1")
        f.write(struct.pack("<qqq", shape[0], shape[1], len(vals)))
        f.write(np.asarray(rows, "<i4").tobytes())
        f.write(np.asarray(cols, "<i4").tobytes())
        f.write(np.asarray(vals, "<f8").tobytes())


def read_sparse_float64(path: str):
    with open(path, "rb") as f:
        if f.read(4) != b"SBF1":
            raise ValueError(f"{path}: not an SBF1 file")
        nrow, ncol, nnz = struct.unpack("<qqq", f.read(24))
        rows = np.frombuffer(f.read(4 * nnz), "<i4").copy()
        cols = np.frombuffer(f.read(4 * nnz), "<i4").copy()
        vals = np.frombuffer(f.read(8 * nnz), "<f8").copy()
    return rows, cols, vals, (int(nrow), int(ncol))
