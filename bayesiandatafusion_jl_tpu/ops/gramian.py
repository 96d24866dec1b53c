"""Per-instance precision/rhs assembly over bucketed observations.

This is the hot kernel of the whole engine (reference: the per-row loop in
``sample_user`` — src/macau.jl [MED], SURVEY.md §4.2/§5.4):

    P_i = Lambda + sum_r alpha_r * sum_{o in Omega_i^r} z_o z_o^T
    b_i = Lambda (mu + beta^T x_i) + sum_r alpha_r * sum_o (v_o - mean_r) z_o

where z_o is the Hadamard product of the other modes' latent rows.
Formulation: for each fixed-width bucket, gather partner latents into a
dense ``[rows, W, K]`` block, form the batched Gramian with one einsum, and
scatter-add into dense ``[N, K, K]`` / ``[N, K]`` accumulators keyed by
instance id.  Chunked head instances accumulate via the same scatter-add.
Relations dense enough for a matmul take ops/dense_gram.py instead.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# Gathered-block transient budget for the [rows, W, K] partner gather
# (charged at its real minor dim K).  Buckets whose gather transient
# exceeds this are processed in ROW CHUNKS — each row's W-reduction stays
# inside one chunk, so chunking is BIT-IDENTICAL to the unchunked einsum
# (oracle equivalence preserved exactly); only the number of chunks
# depends on the budget.
_GATHER_CHUNK_BYTES = 4e9


def bucket_gramian(
    partner_factors: Sequence[jax.Array],  # (arity-1) x [N_d, K]
    part: Sequence[jax.Array],             # (arity-1) x [rows, W] int32
    val: jax.Array,                        # [rows, W]
    mask: jax.Array,                       # [rows, W]
    gram_dtype=None,                       # e.g. jnp.bfloat16: halve gather
    max_gather_bytes: float = None,
) -> Tuple[jax.Array, jax.Array]:
    """Per-row Gramian and rhs contribution of one bucket (without alpha).

    Returns (P [rows, K, K], b [rows, K]).  With ``gram_dtype=bfloat16``
    the gathered partner rows move at half the memory traffic and the
    einsum contracts in bf16 with f32 accumulation (XLA CSEs the one-time
    factor cast across buckets).  Buckets over the gather-transient budget
    run chunked (see _GATHER_CHUNK_BYTES), so arbitrary-scale relations,
    including arity >= 3 at 100M+ nnz, run on this path.
    """
    out_dtype = val.dtype
    if gram_dtype is not None:
        partner_factors = [U.astype(gram_dtype) for U in partner_factors]
    budget = (_GATHER_CHUNK_BYTES if max_gather_bytes is None
              else max_gather_bytes)
    rows, W = val.shape
    K = partner_factors[0].shape[-1]
    itemsize = jnp.dtype(partner_factors[0].dtype).itemsize
    transient = float(rows) * W * K * itemsize * len(partner_factors)

    def fetch(U, p):
        # tiny partner tables (tensor CONTEXT dims, typically <= 32
        # instances) select via a one-hot matmul instead of a second
        # gather stream.  A one-hot dot is an exact single-term
        # selection, so values equal the gather's.
        if U.shape[0] <= 32:
            oh = jax.nn.one_hot(p, U.shape[0], dtype=U.dtype)
            return jnp.einsum("rwc,ck->rwk", oh, U)
        # promise_in_bounds skips gather bounds checks; layout indices
        # are validated at build time
        return U.at[p].get(mode="promise_in_bounds")

    def block(parts_b, val_b, mask_b):
        z = fetch(partner_factors[0], parts_b[0])          # [r, W, K]
        for U, p in zip(partner_factors[1:], parts_b[1:]):
            z = z * fetch(U, p)                            # Hadamard
        zm = z * mask_b[..., None].astype(z.dtype)
        P = jnp.einsum("rwk,rwl->rkl", zm, zm,
                       preferred_element_type=out_dtype)
        b = jnp.einsum("rwk,rw->rk", zm, val_b.astype(z.dtype),
                       preferred_element_type=out_dtype)
        return P, b

    if transient <= budget or rows <= 1:
        return block(part, val, mask)
    n_chunks = min(int(np.ceil(transient / budget)), rows)
    cr = -(-rows // n_chunks)
    full = rows // cr
    rem = rows - full * cr

    def step(start, size, acc):
        P_acc, b_acc = acc
        parts_b = [jax.lax.dynamic_slice_in_dim(p, start, size, 0)
                   for p in part]
        val_b = jax.lax.dynamic_slice_in_dim(val, start, size, 0)
        mask_b = jax.lax.dynamic_slice_in_dim(mask, start, size, 0)
        P, b = block(parts_b, val_b, mask_b)
        return (jax.lax.dynamic_update_slice_in_dim(P_acc, P, start, 0),
                jax.lax.dynamic_update_slice_in_dim(b_acc, b, start, 0))

    acc = (jnp.zeros((rows, K, K), out_dtype),
           jnp.zeros((rows, K), out_dtype))
    if full:
        acc = jax.lax.fori_loop(0, full,
                                lambda i, a: step(i * cr, cr, a), acc)
    if rem:
        acc = step(full * cr, rem, acc)
    return acc


def assemble_precision(
    Lambda: jax.Array,        # [K, K]
    prior_mean: jax.Array,    # [N, K]
    contribs,                 # list of (alpha, partner_factors, bucket dict)
    n: int,
    gram_dtype=None,
    fuse_lambda: bool = False,  # leave Lambda out of P (the sampler adds
                                # it: chol_sample_dispatch(Lambda=...))
) -> Tuple[jax.Array, jax.Array]:
    """P/b accumulators via ONE segment-sum over all buckets' rows.

    Concatenating every bucket's per-row Gramian contributions (across all
    relations/modes touching the entity) and reducing with a single
    ``segment_sum`` does one pass over the [N, K, K] output instead of one
    scatter per bucket.
    """
    K = Lambda.shape[-1]
    P_rows, b_rows, inst_rows = [], [], []
    for alpha, partner_factors, ba in contribs:
        P, b = bucket_gramian(partner_factors, ba["part"], ba["val"],
                              ba["mask"], gram_dtype=gram_dtype)
        P_rows.append(alpha * P)
        b_rows.append(alpha * b)
        inst_rows.append(ba["inst"])
    if fuse_lambda:
        P_acc = jnp.zeros((n, K, K), Lambda.dtype)
    else:
        P_acc = jnp.broadcast_to(Lambda, (n, K, K)).astype(Lambda.dtype)
    b_acc = prior_mean @ Lambda
    if P_rows:
        inst = jnp.concatenate(inst_rows)
        # scatter in 2D [rows, K*K]: one flat trailing dim
        P_flat = jnp.concatenate(
            [p.reshape(p.shape[0], K * K) for p in P_rows])
        P_acc = P_acc + jax.ops.segment_sum(
            P_flat, inst, num_segments=n).reshape(n, K, K)
        b_acc = b_acc + jax.ops.segment_sum(
            jnp.concatenate(b_rows), inst, num_segments=n)
    return P_acc, b_acc


def plan_accumulation(inst_arrays: Sequence[np.ndarray], n: int):
    """Compile-time plan replacing the runtime scatter (host-side NumPy).

    In the bucketed layout an instance owns exactly ONE Gramian row per
    (relation, mode) — plus extra chunk rows only for head instances whose
    degree exceeds the widest bucket.  So the [rows]->[n] reduction is a
    static-index gather of each instance's first row plus a tiny overflow
    segment-sum, instead of a general scatter over all rows (XLA's scatter
    is the slower primitive; the gather formulation is bandwidth-bound).

    Returns dict of numpy arrays: first [n] int32 (concat-row id of the
    first contributing row; 0 if none), has [n] float (0/1), ov_rows
    [R_ex] int32, ov_inst [R_ex] int32.

    NOTE: padded bucket rows carry inst=0 with all-zero contributions;
    they are harmless for the overflow path but must NOT be counted as
    instance 0's "first" row, so callers pass the REAL row count per
    bucket via trimmed inst arrays... here we conservatively treat every
    row as real: zero rows gathered first for instance 0 would DROP its
    real contribution.  To stay exact, instance 0's rows always go
    through the overflow path.
    """
    inst_cat = np.concatenate([np.asarray(a) for a in inst_arrays]) \
        if inst_arrays else np.zeros(0, np.int32)
    rowids = np.arange(len(inst_cat), dtype=np.int64)
    nz = inst_cat != 0
    u, fpos = np.unique(inst_cat[nz], return_index=True)
    first = np.zeros(n, np.int32)
    has = np.zeros(n, np.float32)
    first[u] = rowids[nz][fpos].astype(np.int32)
    has[u] = 1.0
    is_first = np.zeros(len(inst_cat), bool)
    is_first[rowids[nz][fpos]] = True
    ov_rows = rowids[~is_first].astype(np.int32)
    ov_inst = inst_cat[~is_first].astype(np.int32)
    pad = (-len(ov_rows)) % 8 or 8
    # pad with row 0 aimed at sentinel segment n (sliced off by caller)
    ov_rows = np.concatenate([ov_rows, np.zeros(pad, np.int32)])
    ov_inst = np.concatenate([ov_inst, np.full(pad, n, np.int32)])
    return {"first": first, "has": has, "ov_rows": ov_rows,
            "ov_inst": ov_inst}


def assemble_precision_planned(
    Lambda: jax.Array,
    prior_mean: jax.Array,
    contribs,
    n: int,
    plan: dict,                # device arrays from plan_accumulation
    gram_dtype=None,
) -> Tuple[jax.Array, jax.Array]:
    """Accumulate with the compile-time plan: static gather + tiny overflow
    segment-sum (see plan_accumulation)."""
    K = Lambda.shape[-1]
    P_rows, b_rows = [], []
    for alpha, partner_factors, ba in contribs:
        P, b = bucket_gramian(partner_factors, ba["part"], ba["val"],
                              ba["mask"], gram_dtype=gram_dtype)
        P_rows.append(alpha * P)
        b_rows.append(alpha * b)
    P_acc = jnp.broadcast_to(Lambda, (n, K, K)).astype(Lambda.dtype)
    b_acc = prior_mean @ Lambda
    if not P_rows:
        return P_acc, b_acc
    # 2D [rows, K*K] layout for take/segment_sum (see assemble_precision)
    P_cat = jnp.concatenate([p.reshape(p.shape[0], K * K) for p in P_rows])
    b_cat = jnp.concatenate(b_rows)
    has = plan["has"]
    P_acc = P_acc + (jnp.take(P_cat, plan["first"], axis=0)
                     * has[:, None]).reshape(n, K, K)
    b_acc = b_acc + jnp.take(b_cat, plan["first"], axis=0) * has[:, None]
    # overflow: head-instance chunk rows + everything aimed at instance 0
    # (sentinel segment n collects the padding and is sliced off)
    ovP = jax.ops.segment_sum(jnp.take(P_cat, plan["ov_rows"], axis=0),
                              plan["ov_inst"], num_segments=n + 1)[:n]
    ovb = jax.ops.segment_sum(jnp.take(b_cat, plan["ov_rows"], axis=0),
                              plan["ov_inst"], num_segments=n + 1)[:n]
    return P_acc + ovP.reshape(n, K, K), b_acc + ovb


def predict_tuples(
    factors: Sequence[jax.Array],  # D x [N_d, K]
    idx: jax.Array,                # [n, D] int32
    mean_value: jax.Array,         # scalar
) -> jax.Array:
    """pred = mean_r + sum_k prod_d U_d[i_d, k]  (SURVEY §4.7).

    Expressed as one einsum over the gathered operands, so XLA can fuse
    the gathers into the contraction instead of materializing the
    gathered rows.
    """
    gathered = [U.at[idx[:, d]].get(mode="promise_in_bounds")
                for d, U in enumerate(factors)]
    spec = ",".join(["nk"] * len(factors)) + "->n"
    return mean_value + jnp.einsum(spec, *gathered)
