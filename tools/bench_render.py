#!/usr/bin/env python3
"""Render benchmark: rays/s/chip for sphere-traced rendering on the 3D map.

Measures the render path (render.py:sphere_trace) on the generated 3D map:
  * forward: depth + normal + variance per ray
  * forward+backward: same plus gradients of summed hit depth w.r.t. the
    cluster-GP store alphas AND the kernel length scale (the
    hyperparameter path, covFnc.cpp:29-33)

The reference has no ray tracer (its only rendering is dense-grid
evaluation + isosurface, matlab/visualize_gpisMap3.m), so there is no
reference floor.

Usage: python tools/bench_render.py [--frames N] [--sub K] [--cpu]
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
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--sub", type=int, default=2,
                    help="camera-ray subsample (2 -> 320x240 = 76.8k rays)")
    ap.add_argument("--bwd-sub", type=int, default=0,
                    help="ray subsample for the backward measurement "
                    "(0 -> 2*sub: the unrolled-trace gradient holds "
                    "per-step residuals for every ray, so its memory "
                    "footprint is ~n_steps x the forward's)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--try-full-bwd", action="store_true",
                    help="also attempt the full-ray-set unrestricted "
                    "backward (its program is ~n_steps x larger)")
    args = ap.parse_args()

    import jax
    _setup.device(args.cpu)
    import jax.numpy as jnp

    from gpismap import datasets, render
    from gpismap.api3d import GPisMap3D

    m = GPisMap3D()
    frames = list(datasets.tabletop_frames(0, args.frames))
    for i, fr in enumerate(frames):
        m.set_camera(fr.cam_id, "bigbird")
        m.update(fr.depth, fr.pose)
        print(f"# frame {i}: nodes={m.num_nodes} "
              f"update={m.stats.get('update_s')}s", file=sys.stderr,
              flush=True)

    fr = frames[-1]
    pose = np.asarray(fr.pose, np.float32).reshape(-1)
    tr, rot = pose[:3], pose[3:12].reshape(3, 3, order="F")
    o, d, shape = render.camera_rays(tr, rot, m.cam, subsample=args.sub)
    n_rays = len(o)
    cfg = render.config_from_mapper(m)
    factors = m._get_factors()
    o_d, d_d = jax.device_put((jnp.asarray(o), jnp.asarray(d)))

    # ---- forward ----
    out = render.sphere_trace(m.store, m.grid, o_d, d_d, cfg, factors)
    jax.block_until_ready(out)
    _drain(out)
    t0 = time.time()
    for _ in range(args.reps):
        out = render.sphere_trace(m.store, m.grid, o_d, d_d, cfg, factors)
    _drain(out)
    fwd_s = (time.time() - t0) / args.reps
    fwd_rps = n_rays / fwd_s
    hit_frac = float(np.asarray(out["hit"]).mean())

    # ---- forward + backward (store alphas + kernel scale) ----
    # store/grid/factors ride as ARGUMENTS: closing over them bakes the
    # multi-GB factor buffer into the program as constants
    def loss(alpha, scale, store, grid, factors_, o_, d_):
        hyper = render.hyper_from_scale(scale, 3)
        st = store._replace(alpha=alpha)
        out = render.sphere_trace(st, grid, o_, d_, cfg, factors_, hyper)
        return jnp.sum(jnp.where(out["hit"], out["t"], 0.0))

    sc = jnp.asarray(m.p.map_scale_param, jnp.float32)
    bwd_err = None
    bwd_s = bwd_rps = dscale = None
    nb_rays = 0
    if args.try_full_bwd:
        gfun = jax.jit(jax.grad(loss, argnums=(0, 1)))
        bsub = args.bwd_sub or 2 * args.sub
        ob, db, _ = render.camera_rays(tr, rot, m.cam, subsample=bsub)
        nb_rays = len(ob)
        ob_d, db_d = jax.device_put((jnp.asarray(ob), jnp.asarray(db)))
        try:
            g = gfun(m.store.alpha, sc, m.store, m.grid, factors, ob_d,
                     db_d)
            jax.block_until_ready(g)
            _drain(g)
            t0 = time.time()
            for _ in range(args.reps):
                g = gfun(m.store.alpha, sc, m.store, m.grid, factors,
                         ob_d, db_d)
            _drain(g)
            bwd_s = round((time.time() - t0) / args.reps, 4)
            bwd_rps = round(nb_rays / bwd_s, 1)
            dscale = float(g[1])
        except Exception as e:  # noqa: BLE001 — report the forward rows
            bwd_err = repr(e)[:300]
            print(f"# full backward failed: {bwd_err}", file=sys.stderr,
                  flush=True)

    # ---- forward + backward, HIT-COMPACTED (the production recipe:
    # march every ray forward, differentiate the implicit correction of
    # the hit rays only — exact for any hit-masked loss, and the
    # backward program fits the compile service; render.implicit_correct)
    hitm = np.asarray(out["hit"])
    t_hat = np.asarray(out["t_hat"])
    idx = np.nonzero(hitm)[0]
    n_hits = len(idx)
    hpad = max(256, 1 << max(0, (n_hits - 1)).bit_length())
    sel = np.zeros(hpad, np.int64)
    sel[:n_hits] = idx
    w = np.zeros(hpad, np.float32)
    w[:n_hits] = 1.0
    oh, dh, th, wd = jax.device_put(
        (jnp.asarray(o[sel]), jnp.asarray(d[sel]),
         jnp.asarray(t_hat[sel]), jnp.asarray(w)))

    def loss_hits(alpha, scale, store, grid, factors_, o_, d_, th_, w_):
        hyper = render.hyper_from_scale(scale, 3)
        st = store._replace(alpha=alpha)
        t, _, _, _ = render.implicit_correct(st, grid, o_, d_, th_, cfg,
                                             factors_, hyper)
        return jnp.sum(w_ * t)

    ghits = jax.jit(jax.grad(loss_hits, argnums=(0, 1)))
    hb_err = None
    hb_s = hb_rps = hb_dscale = None
    try:
        g = ghits(m.store.alpha, sc, m.store, m.grid, factors, oh, dh,
                  th, wd)
        jax.block_until_ready(g)
        _drain(g)
        t0 = time.time()
        for _ in range(args.reps):
            # forward march (rep) + correction backward of the hit set =
            # the full fwd+bwd pipeline cost per image
            o2 = render.sphere_trace(m.store, m.grid, o_d, d_d, cfg,
                                     factors)
            g = ghits(m.store.alpha, sc, m.store, m.grid, factors, oh,
                      dh, th, wd)
        _drain((o2, g))
        hb_s = round((time.time() - t0) / args.reps, 4)
        hb_rps = round(n_rays / hb_s, 1)
        hb_dscale = float(g[1])
    except Exception as e:  # noqa: BLE001
        hb_err = repr(e)[:300]
        print(f"# hit-compacted backward failed: {hb_err}",
              file=sys.stderr, flush=True)

    out = {
        "metric": "render_rays_per_s_per_chip",
        "value": round(fwd_rps, 1),
        "unit": "rays/s",
        "vs_baseline": None,     # reference has no ray tracer
        "extra": {
            "n_rays": n_rays,
            "image": list(shape),
            "n_steps": cfg.n_steps,
            "hit_fraction": round(hit_frac, 4),
            "forward_s": round(fwd_s, 4),
            "forward_backward_rays_per_s": bwd_rps,
            "forward_backward_s": bwd_s,
            "forward_backward_n_rays": nb_rays,
            "backward_error": bwd_err,
            "grad_wrt_scale": dscale,
            "fwd_bwd_hitcompact_rays_per_s": hb_rps,
            "fwd_bwd_hitcompact_s": hb_s,
            "fwd_bwd_hitcompact_n_hits": n_hits,
            "fwd_bwd_hitcompact_error": hb_err,
            "fwd_bwd_hitcompact_grad_wrt_scale": hb_dscale,
            "n_frames": len(frames),
            "n_nodes": int(m.num_nodes),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
