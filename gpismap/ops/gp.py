"""Batched masked GP fit / posterior for the two GP families.

 - GPou: tiny OU-kernel regressor used by the observation GPs
   (reference: cpp/src/ObsGP.cpp:32-62)
 - OnGPIS: Matern-3/2 SDF GP with gradient observations, one per cluster
   cell (reference: cpp/src/OnGPIS.cpp)

Everything is expressed as capacity-padded batches: [B, M, ...] with a
`valid` mask. Cholesky + triangular solves run batched through XLA;
padded rows are identity-masked by the kernel builders (see ops/kernels.py)
so the factorization of the padded system is exact.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.lax.linalg import triangular_solve

from . import kernels, precision


def _chol(k: jnp.ndarray) -> jnp.ndarray:
    """Batched Cholesky factor (XLA's native op; cuSOLVER on the GPU)."""
    return jnp.linalg.cholesky(k)


def _solve_lower(l: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """L^-1 b with L lower triangular; batched."""
    return triangular_solve(l, b, left_side=True, lower=True,
                            transpose_a=False)


def _solve_chol(l: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(L L^T)^-1 b; batched (the two solveInPlace calls, ObsGP.cpp:43-44)."""
    y = _solve_lower(l, b)
    return triangular_solve(l, y, left_side=True, lower=True,
                            transpose_a=True)


class GPouState(NamedTuple):
    """Batched trained GPou groups (ObsGP.cpp:32-48)."""

    x: jnp.ndarray        # [B, M, D] inputs
    valid: jnp.ndarray    # [B, M] bool
    l: jnp.ndarray        # [B, M, M] Cholesky factor
    alpha: jnp.ndarray    # [B, M]
    trained: jnp.ndarray  # [B] bool — group has >0 samples


def fit_gpou(x: jnp.ndarray, f: jnp.ndarray, valid: jnp.ndarray,
             scale: float, noise: float) -> GPouState:
    """Train a batch of GPou units (reference: ObsGP.cpp:32-48).

    x: [B, M, D], f: [B, M], valid: [B, M].
    """
    f = jnp.where(valid, f, 0.0)
    k = kernels.ou_train_cov(x, noise, valid, scale)
    l = _chol(k)
    alpha = _solve_chol(l, f[..., None])[..., 0]
    return GPouState(x=x, valid=valid, l=l, alpha=alpha,
                     trained=jnp.any(valid, axis=-1))


def gpou_test(state: GPouState, xt: jnp.ndarray, scale: float, noise: float):
    """Posterior mean/variance at xt [B, Q, D] (reference: ObsGP.cpp:50-62).

    Returns (mean [B, Q], var [B, Q]); var = 1 + noise - sum((L^-1 k*)^2).
    """
    ks = kernels.ou_cross_cov(state.x, state.valid, xt, scale)  # [B, M, Q]
    mean = precision.einsum('...mq,...m->...q', ks, state.alpha)
    v = _solve_lower(state.l, ks)
    var = 1.0 + noise - jnp.sum(v * v, axis=-2)
    return mean, var


def linv_from_chol(l: jnp.ndarray) -> jnp.ndarray:
    """Explicit L^-1 from a (masked) Cholesky factor.

    Turning the per-query triangular solve of the reference
    (ObsGP.cpp:56-59) into one precomputed inverse + per-query matvecs keeps
    the test path pure-matmul instead of many tiny solves, while the
    variance ||L^-1 k||^2 stays the reference's numerically-stable form
    (better conditioned than k^T K^-1 k with an explicit K^-1).
    """
    m = l.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(m, dtype=l.dtype), l.shape)
    return triangular_solve(l, eye, left_side=True, lower=True)


def gpou_posterior_gather(x: jnp.ndarray, alpha: jnp.ndarray,
                          linv: jnp.ndarray, valid: jnp.ndarray,
                          trained: jnp.ndarray, cell_idx: jnp.ndarray,
                          q: jnp.ndarray, scale: float, noise: float,
                          chunk: int = 4096):
    """Evaluate many single-point GPou posteriors, one (small) GP per query.

    This is the batched equivalent of the reference's threaded per-point group
    lookup + GPou::test (ObsGP.cpp:352-463): each query gathers its group's
    state and evaluates mean/var with batched matvecs, chunked to bound the
    gather footprint.

    x:        [S, M, D] per-group inputs
    alpha:    [S, M]
    linv:     [S, M, M] precomputed L^-1 (see linv_from_chol)
    valid:    [S, M]
    trained:  [S] bool
    cell_idx: [Q] int32 group id per query (clipped to [0, S))
    q:        [Q, D]
    Returns (mean [Q], var [Q]); untrained groups give (0, 1e6) matching the
    reference sentinel (ObsGP.cpp:161,363).
    """
    nq = q.shape[0]
    pad = (-nq) % chunk
    cell_p = jnp.concatenate([cell_idx, jnp.zeros(pad, cell_idx.dtype)])
    q_p = jnp.concatenate([q, jnp.zeros((pad,) + q.shape[1:], q.dtype)])
    cell_p = cell_p.reshape(-1, chunk)
    q_p = q_p.reshape(-1, chunk, q.shape[-1])

    def eval_chunk(args):
        ci, qc = args
        xs = x[ci]                     # [C, M, D]
        al = alpha[ci]
        li = linv[ci]
        vl = valid[ci]
        diff = xs - qc[:, None, :]
        r = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
        ks = jnp.where(vl, jnp.exp(-r / scale), 0.0)   # [C, M]
        mean = jnp.sum(ks * al, axis=-1)
        v = precision.einsum('cmn,cn->cm', li, ks)           # L^-1 k*
        var = 1.0 + noise - jnp.sum(v * v, axis=-1)
        tr = trained[ci]
        return jnp.where(tr, mean, 0.0), jnp.where(tr, var, 1e6)

    mean, var = jax.lax.map(eval_chunk, (cell_p, q_p))
    return mean.reshape(-1)[:nq], var.reshape(-1)[:nq]


class OnGPISState(NamedTuple):
    """Batched trained cluster GPs (OnGPIS.cpp:34-149)."""

    x: jnp.ndarray         # [B, M, D]
    valid: jnp.ndarray     # [B, M] bool
    gradflag: jnp.ndarray  # [B, M] bool
    l: jnp.ndarray         # [B, M*(1+D), M*(1+D)]
    alpha: jnp.ndarray     # [B, M*(1+D)]
    trained: jnp.ndarray   # [B]


def ongpis_prepare(grad: jnp.ndarray, sigx: jnp.ndarray,
                   siggrad: jnp.ndarray, valid: jnp.ndarray):
    """Gradient-validity rule (reference: OnGPIS.cpp:63-65,122-124).

    A node contributes gradient rows unless its gradient noise exceeds
    0.1001 or its gradient is (numerically) zero; such nodes get value
    noise bumped to 2.0.
    Returns (gradflag [B, M] bool, sigx_adjusted [B, M]).
    """
    no_grad = (siggrad > 0.1001) | jnp.all(jnp.abs(grad) < 1e-6, axis=-1)
    gradflag = valid & (~no_grad)
    sigx = jnp.where(valid & no_grad, 2.0, sigx)
    return gradflag, sigx


def fit_ongpis(x: jnp.ndarray, grad: jnp.ndarray, val: jnp.ndarray,
               sigx: jnp.ndarray, siggrad: jnp.ndarray, valid: jnp.ndarray,
               scale: float) -> OnGPISState:
    """Train a batch of cluster SDF GPs (reference: OnGPIS.cpp:34-89).

    x: [B, M, D] node positions; grad: [B, M, D] unit normals;
    val: [B, M] SDF targets (-fbias at surface hits); sigx/siggrad: [B, M]
    noises; valid: [B, M].
    Target layout y = [f; gx; gy(; gz)] (OnGPIS.cpp:75-76,135-136) with
    masked rows set to 0.
    """
    d = x.shape[-1]
    gradflag, sigx = ongpis_prepare(grad, sigx, siggrad, valid)
    k = kernels.matern32_deriv_train_cov(x, sigx, siggrad, gradflag, valid,
                                         scale)
    gmaskf = gradflag.astype(x.dtype)
    y = jnp.concatenate(
        [jnp.where(valid, val, 0.0)]
        + [grad[..., i] * gmaskf for i in range(d)], axis=-1)
    l = _chol(k)
    alpha = _solve_chol(l, y[..., None])[..., 0]
    return OnGPISState(x=x, valid=valid, gradflag=gradflag, l=l, alpha=alpha,
                       trained=jnp.any(valid, axis=-1))


def ongpis_test(state: OnGPISState, xt: jnp.ndarray, scale: float,
                val_const: float, grad_const: float):
    """Posterior SDF value/gradient + variances at xt [B, Q, D].

    Parity: OnGPIS.cpp:218-263 (test2Dpoint: val_const=1.01,
    grad_const=3/l^2+0.1) and :177-216 (testSinglePoint 3D branch:
    val_const=1.001, grad_const=3/l^2+0.001).

    Returns (f [B, Q], grad [B, Q, D], varf [B, Q], vargrad [B, Q, D]).
    """
    d = xt.shape[-1]
    q = xt.shape[-2]
    ks = kernels.matern32_deriv_cross_cov(state.x, state.gradflag,
                                          state.valid, xt, scale)
    res = precision.einsum('...mq,...m->...q', ks, state.alpha)  # [B, (1+D)Q]
    f = res[..., :q]
    grad = jnp.stack([res[..., (1 + i) * q:(2 + i) * q] for i in range(d)],
                     axis=-1)
    v = _solve_lower(state.l, ks)
    vsum = jnp.sum(v * v, axis=-2)
    varf = val_const - vsum[..., :q]
    vargrad = jnp.stack(
        [grad_const - vsum[..., (1 + i) * q:(2 + i) * q] for i in range(d)],
        axis=-1)
    return f, grad, varf, vargrad
