"""Matmul precision of the GP fit and query math — the one owner.

On an NVIDIA GPU a float32 contraction left at DEFAULT precision may run
in TF32 (about three decimal digits). The GP posterior variance is
`const - ||L^-1 k*||^2`, a difference of nearly equal terms, and the fit
solves ill-conditioned systems, so every contraction on the fit, update
and query paths runs at float32 HIGHEST through `einsum`/`matmul` below.
Lowering it needs a measurement of the variance error it causes
(tests/test_precision.py checks that every contraction uses it).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

MATMUL = jax.lax.Precision.HIGHEST


def einsum(spec: str, *operands):
    return jnp.einsum(spec, *operands, precision=MATMUL)


def matmul(a, b):
    return jnp.matmul(a, b, precision=MATMUL)
