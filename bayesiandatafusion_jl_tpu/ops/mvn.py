"""Batched Cholesky factorize-and-sample for per-row latent conditionals.

Reference: the per-row ``chol(P) \\ ...`` inside ``sample_user``
(src/macau.jl [MED], SURVEY.md §4.2):

    u_i <- mu* + L^{-T} xi,   P_i = L L^T,  mu* = P_i^{-1} b_i,  xi ~ N(0, I)

Formulation: one batched ``[N, K, K]`` Cholesky + batched triangular
solves (XLA hands these to the GPU solver libraries).  The
covariance of ``L^{-T} xi`` is ``P^{-1}`` — exact MVN sampling without ever
forming the covariance.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.lax import linalg as lxl


def chol_sample(P: jax.Array, b: jax.Array, xi: jax.Array,
                jitter: float = 0.0) -> jax.Array:
    """Sample u ~ N(P^{-1} b, P^{-1}) batched over leading dims.

    P: [..., K, K], b/xi: [..., K].
    """
    K = P.shape[-1]
    if jitter:
        P = P + jitter * jnp.eye(K, dtype=P.dtype)
    L = lxl.cholesky(P)  # lower
    bb = b[..., None]
    y = lxl.triangular_solve(L, bb, left_side=True, lower=True,
                             transpose_a=False)
    mu = lxl.triangular_solve(L, y, left_side=True, lower=True,
                              transpose_a=True)
    u = lxl.triangular_solve(L, xi[..., None], left_side=True, lower=True,
                             transpose_a=True)
    return (mu + u)[..., 0]


def chol_sample_dispatch(cfg, P: jax.Array, b: jax.Array, xi: jax.Array,
                         Lambda: jax.Array | None = None) -> jax.Array:
    """The engines' sampler entry point: when ``Lambda`` is given it is
    added to every P_i first (the head-split accumulators leave it out so
    the ghost rows can be psum-reduced without it), then
    :func:`chol_sample` with the configured jitter."""
    if Lambda is not None:
        P = P + Lambda
    return chol_sample(P, b, xi, cfg.chol_jitter)


def chol_solve(P: jax.Array, b: jax.Array) -> jax.Array:
    """P^{-1} b via Cholesky, batched. b: [..., K] or [..., K, M]."""
    L = lxl.cholesky(P)
    vec = b.ndim == P.ndim - 1
    bb = b[..., None] if vec else b
    y = lxl.triangular_solve(L, bb, left_side=True, lower=True)
    x = lxl.triangular_solve(L, y, left_side=True, lower=True, transpose_a=True)
    return x[..., 0] if vec else x
