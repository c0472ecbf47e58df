"""Covariance kernels for GPIS — masked, batched, static-shape jnp.

Closed forms match the reference math (reference: cpp/src/covFnc.cpp):

  Ornstein-Uhlenbeck:  k(r) = exp(-r/l)                      (covFnc.cpp:47-109)
  Matern-3/2 family, a = sqrt(3)/l:                          (covFnc.cpp:29-33)
      kf (r)            = (1 + a r) exp(-a r)
      kf1(r, dx)        = a^2 dx exp(-a r)
      kf2(r, dx1, dx2, d) = a^2 (d - a dx1 dx2 / r) exp(-a r)

Design difference vs the reference (deliberate, for static shapes): the reference
compacts gradient rows with a `gradflag` reindexing pass (covFnc.cpp:151-161)
producing data-dependent matrix sizes. Here every node keeps (1+D) rows and
invalid rows/cols are *masked* to identity: unit diagonal, zero off-diagonal,
zero target. K is then a symmetric permutation of blockdiag(K_compact, I), so
alpha = K^-1 y, posterior means k*^T alpha and variances k*^T K^-1 k* are
EXACTLY the compacted values while every shape stays static for XLA.

Row/column block layout (matches covFnc.cpp:163,338 and :283,428):
  train rows/cols:  [f_0..f_{M-1}, gx_0..gx_{M-1}, gy_..., (gz_...)]
  test columns:     [f*_0..f*_{Q-1}, gx*_..., gy*_..., (gz*_...)]

All functions are rank-polymorphic over leading batch dimensions.
"""
from __future__ import annotations

import jax.numpy as jnp

_SQRT3 = 1.7320508075688772


def _pairwise(x1: jnp.ndarray, x2: jnp.ndarray):
    """diff[..., N, M, D] = x1 - x2 (broadcast), r[..., N, M] Euclidean."""
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    r = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    return diff, r


def ou_train_cov(x: jnp.ndarray, sig, valid: jnp.ndarray, scale: float):
    """OU train covariance with masking.

    Parity: covFnc.cpp:47-91 (both scalar- and vector-noise overloads;
    pass `sig` as a scalar or an [..., M] array).

    x:     [..., M, D] inputs
    sig:   scalar or [..., M] noise added on the diagonal (diag = 1 + sig)
    valid: [..., M] bool; invalid rows/cols become identity
    """
    m = x.shape[-2]
    _, r = _pairwise(x, x)
    k = jnp.exp(-r / scale)
    eye = jnp.eye(m, dtype=x.dtype)
    sig = jnp.asarray(sig, dtype=x.dtype)
    diag = 1.0 + jnp.broadcast_to(sig, r.shape[:-2] + (m,))
    k = k * (1.0 - eye) + diag[..., :, None] * eye
    vmask = valid[..., :, None] & valid[..., None, :]
    k = jnp.where(vmask, k, 0.0)
    # identity diagonal for invalid rows keeps K positive definite
    k = jnp.where((~valid[..., :, None]) & (eye > 0), 1.0, k)
    return k


def ou_cross_cov(x1: jnp.ndarray, valid: jnp.ndarray, x2: jnp.ndarray,
                 scale: float):
    """OU cross covariance train x test (covFnc.cpp:93-109).

    Invalid train rows are zeroed so they contribute nothing to the
    posterior. Test columns are NOT masked; callers discard padded outputs.
    """
    _, r = _pairwise(x1, x2)
    k = jnp.exp(-r / scale)
    return jnp.where(valid[..., :, None], k, 0.0)


def _matern_parts(diff, r, scale, dtype):
    a = jnp.asarray(_SQRT3 / scale, dtype)
    e = jnp.exp(-a * r)
    kf = (1.0 + a * r) * e
    kf1 = (a * a) * diff * e[..., None]          # [..., N, M, D]
    # kf2[..., N, M, D, D]; safe divide for r == 0 (limit along dx -> 0
    # is a^2 * delta; the reference would produce NaN there, covFnc.cpp:31-33)
    inv_r = jnp.where(r > 0, 1.0 / jnp.where(r > 0, r, 1.0), 0.0)
    outer = diff[..., :, None] * diff[..., None, :]   # dx1*dx2
    d = diff.shape[-1]
    delta = jnp.eye(d, dtype=dtype)
    kf2 = (a * a) * (delta - a * outer * inv_r[..., None, None]) \
        * e[..., None, None]
    return a, kf, kf1, kf2


def matern32_deriv_train_cov(x: jnp.ndarray, sigx, siggrad,
                             gradflag: jnp.ndarray, valid: jnp.ndarray,
                             scale: float):
    """Matern-3/2 joint value+gradient train covariance, masked.

    Parity: covFnc.cpp:317-402 (2D) and :142-256 (3D). Returns
    [..., M*(1+D), M*(1+D)].

    sigx:     [..., M] value noise (already 2.0-overridden for no-grad nodes
              by the caller, matching OnGPIS.cpp:63-65)
    siggrad:  [..., M] gradient noise
    gradflag: [..., M] bool — node contributes gradient observations
    valid:    [..., M] bool — node exists

    2D quirk kept for parity: the x-gradient diagonal uses
    sqrt(sigx*siggrad) while y uses siggrad (covFnc.cpp:352,355); in 3D all
    three use siggrad (covFnc.cpp:181-189).
    """
    dtype = x.dtype
    m, d = x.shape[-2], x.shape[-1]
    diff, r = _pairwise(x, x)
    a, kf, kf1, kf2 = _matern_parts(diff, r, scale, dtype)
    a2 = a * a
    eye = jnp.eye(m, dtype=dtype)
    off = 1.0 - eye

    sigx = jnp.broadcast_to(jnp.asarray(sigx, dtype), r.shape[:-2] + (m,))
    siggrad = jnp.broadcast_to(jnp.asarray(siggrad, dtype),
                               r.shape[:-2] + (m,))

    # value block: diag 1+sigx (covFnc.cpp:346)
    k_ff = kf * off + (1.0 + sigx)[..., :, None] * eye

    # gradient-row x value-col: -kf1 (covFnc.cpp:364-367), zero diag
    k_gf = -jnp.moveaxis(kf1, -1, -3) * off          # [..., D, M, M]

    # gradient x gradient: kf2 off-diagonal (covFnc.cpp:378-385)
    k_gg = jnp.moveaxis(kf2, (-2, -1), (-4, -3)) * off  # [..., D, D, M, M]

    # diagonals of the gradient blocks
    if d == 2:
        gdiag0 = a2 + jnp.sqrt(sigx * siggrad)   # covFnc.cpp:352
        gdiags = jnp.stack([gdiag0, a2 + siggrad], axis=-2)  # [..., D, M]
    else:
        gdiags = jnp.stack([a2 + siggrad] * d, axis=-2)      # covFnc.cpp:181-189
    delta_ax = jnp.eye(d, dtype=dtype)[..., :, :, None, None]
    k_gg = k_gg + delta_ax * gdiags[..., :, None, :, None] * eye

    # assemble [(1+D)M, (1+D)M]
    row_f = jnp.concatenate(
        [k_ff] + [jnp.swapaxes(k_gf[..., i, :, :], -1, -2) for i in range(d)],
        axis=-1)
    rows_g = [
        jnp.concatenate([k_gf[..., i, :, :]]
                        + [k_gg[..., i, j, :, :] for j in range(d)], axis=-1)
        for i in range(d)
    ]
    big = jnp.concatenate([row_f] + rows_g, axis=-2)

    # masking: f rows need `valid`; gradient rows need `valid & gradflag`
    gmask = valid & gradflag
    rowmask = jnp.concatenate([valid] + [gmask] * d, axis=-1)  # [..., (1+D)M]
    pair = rowmask[..., :, None] & rowmask[..., None, :]
    big = jnp.where(pair, big, 0.0)
    beye = jnp.eye((1 + d) * m, dtype=dtype)
    big = jnp.where((~rowmask[..., :, None]) & (beye > 0), 1.0, big)
    return big


def matern32_deriv_cross_cov(x: jnp.ndarray, gradflag: jnp.ndarray,
                             valid: jnp.ndarray, xt: jnp.ndarray,
                             scale: float):
    """Matern-3/2 cross covariance: train (M, with grads) x test (Q).

    Parity: covFnc.cpp:404-450 (2D), :258-314 (3D). Returns
    [..., M*(1+D), Q*(1+D)] with column blocks [f*, gx*, gy*(, gz*)].
    Rows of invalid/no-gradient entries are zeroed (they then contribute
    nothing to posterior mean or variance — exact equivalent of the
    reference's compaction).
    """
    dtype = x.dtype
    m, d = x.shape[-2], x.shape[-1]
    q = xt.shape[-2]
    diff, r = _pairwise(x, xt)                     # x_k - q_j
    _, kf, kf1, kf2 = _matern_parts(diff, r, scale, dtype)

    # f rows: [kf, +kf1_x, +kf1_y, ...]   (covFnc.cpp:435-437)
    row_f = jnp.concatenate(
        [kf] + [kf1[..., i] for i in range(d)], axis=-1)     # [..., M, Q(1+D)]
    # g_ax rows: [-kf1_ax, kf2[ax,0], kf2[ax,1], ...]  (covFnc.cpp:439-444)
    rows_g = [
        jnp.concatenate([-kf1[..., i]]
                        + [kf2[..., i, j] for j in range(d)], axis=-1)
        for i in range(d)
    ]
    big = jnp.concatenate([row_f] + rows_g, axis=-2)  # [..., (1+D)M, (1+D)Q]

    gmask = valid & gradflag
    rowmask = jnp.concatenate([valid] + [gmask] * d, axis=-1)
    return jnp.where(rowmask[..., :, None], big, 0.0)
