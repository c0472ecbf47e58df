#!/usr/bin/env python3
"""2D render benchmark: rays/s fwd and fwd+bwd on the generated 2D map.

The 2D twin of tools/bench_render.py (LiDAR-style rays from the last
scan's pose; backward = gradients of summed hit depth w.r.t. store alphas
AND the kernel scale). Same ray count forward and backward.

Usage: python tools/bench_render2d.py [--rays N] [--reps K] [--cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import _setup  # noqa: E402



def _drain(out):
    """Wait until the device has finished the result."""
    import jax
    jax.block_until_ready(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import jax
    _setup.device(args.cpu)
    import jax.numpy as jnp

    from gpismap import datasets, render
    from gpismap.api import GPisMap2D

    m = GPisMap2D()
    frames = list(datasets.floor_frames(0))
    m.update_batch([(fr.thetas, fr.ranges, fr.pose) for fr in frames])
    cfg = render.config_from_mapper(m, n_steps=args.steps)
    factors = m._get_factors()
    pose = frames[-1].pose
    tr = np.asarray(pose[:2], np.float32)
    ang = np.linspace(-np.pi, np.pi, args.rays,
                      endpoint=False).astype(np.float32)
    d = np.stack([np.cos(ang), np.sin(ang)], -1)
    o = np.broadcast_to(tr, d.shape).astype(np.float32)
    o_d, d_d = jax.device_put((jnp.asarray(o), jnp.asarray(d)))

    out = render.sphere_trace(m.store, m.grid, o_d, d_d, cfg, factors)
    jax.block_until_ready(out)
    _drain(out)
    t0 = time.time()
    for _ in range(args.reps):
        out = render.sphere_trace(m.store, m.grid, o_d, d_d, cfg, factors)
    _drain(out)
    fwd_s = (time.time() - t0) / args.reps
    hit = float(np.asarray(out["hit"]).mean())

    def loss(alpha, scale, store, grid, factors_, o_, d_):
        st = store._replace(alpha=alpha)
        r = render.sphere_trace(st, grid, o_, d_, cfg, factors_,
                                render.hyper_from_scale(scale, 2))
        return jnp.sum(jnp.where(r["hit"], r["t"], 0.0))

    gfun = jax.jit(jax.grad(loss, argnums=(0, 1)))
    sc = jnp.float32(m.p.map_scale_param)
    bwd_s = dscale = bwd_err = None
    try:
        g = gfun(m.store.alpha, sc, m.store, m.grid, factors, o_d, d_d)
        jax.block_until_ready(g)
        _drain(g)
        t0 = time.time()
        for _ in range(args.reps):
            g = gfun(m.store.alpha, sc, m.store, m.grid, factors, o_d,
                     d_d)
        _drain(g)
        bwd_s = round((time.time() - t0) / args.reps, 4)
        dscale = float(g[1])
    except Exception as e:  # noqa: BLE001
        bwd_err = repr(e)[:300]
        print(f"# backward failed: {bwd_err}", file=sys.stderr, flush=True)

    out = {
        "metric": "render2d_rays_per_s_per_chip",
        "value": round(args.rays / fwd_s, 1),
        "unit": "rays/s",
        "vs_baseline": None,
        "extra": {
            "n_rays": args.rays, "n_steps": args.steps,
            "hit_fraction": round(hit, 4),
            "forward_s": round(fwd_s, 4),
            "forward_backward_s": bwd_s,
            "forward_backward_rays_per_s": (
                round(args.rays / bwd_s, 1) if bwd_s else None),
            "backward_error": bwd_err,
            "grad_wrt_scale": dscale,
            "n_nodes": int(m.num_nodes),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
