"""Hyperparameter Gibbs conditionals: Normal-Wishart, lambda_beta, alpha.

Reference: ``ConditionalNormalWishart`` and the scalar Gamma updates in
src/macau.jl [MED]; exact math in SURVEY.md §4.3/§4.5.  Wishart sampling is
done on the device via the Bartlett decomposition (SURVEY §9.2): no
Distributions.jl — a KxK triangular construction from chi-square (Gamma)
diagonals and standard-normal strict-lower entries.

All draws come pre-generated from the randoms pytree (utils/rng.py): the
Gamma *shape* parameters of every conditional here are static, only rates
are state-dependent, so ``g ~ Gamma(shape, 1)`` is drawn ahead and scaled by
``1/rate`` inside.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.lax import linalg as lxl


def bartlett_wishart(chi2: jax.Array, normals: jax.Array,
                     M_lower: jax.Array) -> jax.Array:
    """Sample Lambda ~ Wishart(W, nu) with W = (M M^T)^{-1}.

    chi2: [K] chi-square draws with dfs (nu - i), i = 0..K-1 (precomputed as
    2 * Gamma((nu - i)/2, 1)); normals: [K, K] std normals (strict lower
    used); M_lower: Cholesky factor of W^{-1} (the posterior *precision* of
    the Wishart scale — we get W^{-1} naturally, never invert).

    Bartlett: A lower-triangular with A_ii = sqrt(chi2_i), A_{ij,i>j} ~ N(0,1);
    then B = M^{-T} satisfies B B^T = W and Lambda = (B A)(B A)^T ~ W(W, nu).
    Returns (Lambda, BA) where BA is a factor of Lambda (BA BA^T = Lambda).
    """
    K = chi2.shape[0]
    A = jnp.tril(normals, -1) + jnp.diag(jnp.sqrt(chi2))
    BA = lxl.triangular_solve(M_lower, A, left_side=True, lower=True,
                              transpose_a=True)  # M^{-T} A
    Lambda = BA @ BA.T
    return Lambda, BA


def normal_wishart_update(
    S: jax.Array,          # [N, K] residual U - uhat
    b0: float,
    nu0: float,
    chi2: jax.Array,       # [K] from randoms (dfs nu0 + N - i)
    tri_normals: jax.Array,  # [K, K] std normals for Bartlett
    mu_normals: jax.Array,   # [K] std normals for the mu draw
) -> Tuple[jax.Array, jax.Array]:
    """One Normal-Wishart conditional draw (SURVEY §4.3), mu0 = 0, W0 = I.

    Returns (mu, Lambda).
    """
    N, _ = S.shape
    Sbar = jnp.mean(S, axis=0)
    Sc = S - Sbar
    scatter = Sc.T @ Sc
    return normal_wishart_from_moments(N, Sbar, scatter, b0, nu0, chi2,
                                       tri_normals, mu_normals)


def normal_wishart_from_moments(
    N: int,
    Sbar: jax.Array,       # [K] residual mean (psum-reduced when sharded)
    scatter: jax.Array,    # [K, K] centered scatter matrix
    b0: float,
    nu0: float,
    chi2: jax.Array,
    tri_normals: jax.Array,
    mu_normals: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """NW draw from sufficient statistics — the shard_map path computes
    (Sbar, scatter) with psum over the instance shards and every device
    makes the identical replicated draw."""
    K = Sbar.shape[0]
    dtype = Sbar.dtype
    b_star = b0 + N
    mu_star = (N * Sbar) / b_star                      # mu0 = 0
    Winv_star = (jnp.eye(K, dtype=dtype) + scatter
                 + (b0 * N / b_star) * jnp.outer(Sbar, Sbar))
    M = lxl.cholesky(Winv_star)                        # lower, W* = (M M^T)^{-1}
    Lambda, BA = bartlett_wishart(chi2, tri_normals, M)
    # mu ~ N(mu*, (b* Lambda)^{-1});  (BA)^{-T} x solved as M @ (A^{-T} x)
    w = lxl.triangular_solve(jnp.tril(tri_normals, -1)
                             + jnp.diag(jnp.sqrt(chi2)),
                             mu_normals[:, None], left_side=True, lower=True,
                             transpose_a=True)
    mu = mu_star + (M @ w)[:, 0] / jnp.sqrt(jnp.asarray(b_star, dtype))
    return mu, Lambda


def sample_lambda_beta(beta: jax.Array, Lambda: jax.Array, g: jax.Array,
                       nu_beta: float, lambda_beta_mean: float) -> jax.Array:
    """lambda_beta | beta, Lambda ~ Gamma((nu+F*K)/2, rate=(nu/mean + tr(b'b L))/2).

    ``g`` is a pre-drawn Gamma((nu + F*K)/2, 1) variate (SURVEY §4.5).
    """
    tr = jnp.einsum("fk,fl,kl->", beta, beta, Lambda)
    rate = (nu_beta / lambda_beta_mean + tr) / 2.0
    return g / rate


def sample_alpha(sse: jax.Array, n_obs: int, g: jax.Array,
                 a0: float, b0: float) -> jax.Array:
    """alpha_r | residuals ~ Gamma(a0 + n/2, rate=b0 + SSE/2) (SURVEY §4.5).

    ``g`` is a pre-drawn Gamma(a0 + n/2, 1) variate.
    """
    rate = b0 + sse / 2.0
    return g / rate
