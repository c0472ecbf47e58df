#!/usr/bin/env python3
"""Toy hyperparameter fit: learn the Matern length scale by gradient
descent on the GPIS posterior.

The reference hard-codes the map scale (params.h:73: 1.2 for 2D); here it
is a traced scalar, so we can FIT it: build a unit-circle map, then
minimize the squared error between the posterior SDF and the analytic
signed distance (|x| - 1) at off-surface probe points. Gradients flow
through the batched cluster-GP fit (retrain_cells), the factorization and
the cross-covariance (see tests/test_hypergrad.py for FD verification).

Run: python demos/demo_hyperfit.py [--cpu]
"""
import argparse
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    from gpismap import render
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    from test_hypergrad import _cfg, _circle_support, _fit

    cap, data, grid = _circle_support(n=60, m=16)
    cfg = _cfg(cap)

    # probe ring: analytic SDF of the unit circle
    rng = np.random.default_rng(0)
    rad = rng.uniform(0.55, 1.6, 128).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, 128).astype(np.float32)
    q = jnp.asarray(np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1))
    sdf_true = jnp.asarray(rad - 1.0)

    @jax.jit
    def loss_fn(log_scale):
        s = jnp.exp(log_scale)
        store = _fit(cap, data, s)
        f, _, _ = render.sdf_eval(store, grid, q, cfg,
                                  hyper=render.hyper_from_scale(s, 2))
        return jnp.mean((f - sdf_true) ** 2)

    log_s = jnp.log(jnp.asarray(0.35, jnp.float32))   # deliberately bad init
    opt = optax.adam(0.05)
    state = opt.init(log_s)
    vg = jax.jit(jax.value_and_grad(loss_fn))
    for i in range(args.steps):
        loss, g = vg(log_s)
        upd, state = opt.update(g, state)
        log_s = optax.apply_updates(log_s, upd)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  scale={float(jnp.exp(log_s)):.4f}  "
                  f"loss={float(loss):.6f}  dloss/dlog_s={float(g):+.5f}")

    final = float(jnp.exp(log_s))
    l0 = float(loss_fn(jnp.log(jnp.asarray(0.35, jnp.float32))))
    l1 = float(loss_fn(log_s))
    print(f"fitted scale: {final:.4f}  (loss {l0:.6f} -> {l1:.6f})")
    assert l1 < l0 * 0.5, "fit should at least halve the loss"
    return 0


if __name__ == "__main__":
    sys.exit(main())
