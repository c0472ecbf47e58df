#!/usr/bin/env python3
"""Benchmark: the 2D workload on one GPU.

Builds the map from the 28 generated floor-plan scans
(gpismap.datasets.floor_frames) through update_batch, then times the
batched SDF+gradient query on the 49,551-point grid. Prints ONE JSON line
with the device it ran on:
  {"metric": ..., "value": queries/s, "unit": "queries/s", "device": ...}

Update rate is the wall time of a second pass over the same frames (the
first pass compiles); query throughput is the query program re-dispatched
on a device-resident batch, ending in block_until_ready. Refuses to run
without a GPU unless --cpu is passed.
"""
import argparse
import json
import sys
import time

import numpy as np

N_FRAMES = 28


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="allow a run without a GPU (not a device number)")
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu:
        sys.exit(f"bench: needs a GPU, JAX found {dev.platform}")
    from gpismap import datasets
    from gpismap.api import GPisMap2D, _next_pow2
    from gpismap.models import cluster
    from gpismap.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    frames = [(f.thetas, f.ranges, f.pose)
              for f in datasets.floor_frames(0, N_FRAMES)]
    m = GPisMap2D()
    t0 = time.time()
    m.update_batch(frames)
    jax.block_until_ready(m.store)
    warm_wall = time.time() - t0
    m.reset()
    t0 = time.time()
    m.update_batch(frames)
    jax.block_until_ready(m.store)
    batch_wall = time.time() - t0
    print(f"# update: first pass {warm_wall:.1f} s, second pass "
          f"{batch_wall:.2f} s ({len(frames) / batch_wall:.1f} frames/s), "
          f"nodes={m.num_nodes}", file=sys.stderr, flush=True)

    xtest, _ = datasets.gazebo_test_grid()
    m.test(xtest)                       # builds the caches, compiles
    xq = np.full((_next_pow2(len(xtest)), 2), 1e6, np.float32)
    xq[:len(xtest)] = xtest
    xq_d = jax.device_put(jnp.asarray(xq))

    def dispatch():
        return cluster.map_test(
            m.store, m.grid, xq_d, factors=m._get_factors(),
            nbrs=m._nbrs,
            nbr_dense=m._nbr_dense, **m._test_kwargs())

    jax.block_until_ready(dispatch())
    t0 = time.time()
    for _ in range(args.reps):
        h = dispatch()
    jax.block_until_ready(h)
    dt = (time.time() - t0) / args.reps

    print(json.dumps({
        "metric": "2d_sdf_grad_queries_per_s",
        "value": len(xtest) / dt,
        "unit": "queries/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": 1},
        "extra": {
            "update_frames_per_s": len(frames) / batch_wall,
            "update_first_pass_s_incl_compiles": warm_wall,
            "n_frames": len(frames),
            "n_nodes": int(m.num_nodes),
            "n_test_points": int(len(xtest)),
            "test_s": dt,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
