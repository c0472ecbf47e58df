#!/usr/bin/env python3
"""A/B timings on one GPU for the path switches whose defaults were
picked on the H100: the candidate table vs the window gather (query), one
retrain-fit dispatch vs one per support-size bucket, and the compacted vs
dense (blocked or gather) 3D observation-GP sweep (update).

    python tools/hopper_ab.py [--only query,gates] [--out FILE]

Every pair is timed in one process, on one card, in turns. Update times are
whole-sequence wall time of a second pass over the same generated frames
(the first pass compiles); query times are the median of repeated
map_test calls on a device-resident batch, each ending in
block_until_ready. Refuses to run without a GPU unless --cpu is passed.
Prints one JSON line per measurement and writes them all to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _setup  # noqa: E402

ROWS = []


def emit(**row) -> None:
    ROWS.append(row)
    print(json.dumps(row), flush=True)


def median_time(fn, reps: int = 5) -> float:
    import jax
    jax.block_until_ready(fn())               # warm (compile)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def frames(dim: int, n: int):
    from gpismap import datasets
    if dim == 2:
        return [(f.thetas, f.ranges, f.pose)
                for f in datasets.floor_frames(0, n)]
    return [(f.depth, f.pose, f.cam_id)
            for f in datasets.tabletop_frames(0, n)]


def new_mapper(dim: int):
    from gpismap import GPisMap2D, GPisMap3D
    return GPisMap2D() if dim == 2 else GPisMap3D()


def update_wall(dim: int, fr, env=None, one_fit=None) -> dict:
    """Second-pass update_batch wall time under the given switches."""
    import jax
    from gpismap.api import _MeshMixin

    old_env = {k: os.environ.get(k) for k in (env or {})}
    old_fit = _MeshMixin.one_fit_dispatch
    try:
        os.environ.update(env or {})
        if one_fit is not None:
            _MeshMixin.one_fit_dispatch = one_fit
        jax.clear_caches()                # trace-time switches re-trace
        m = new_mapper(dim)
        t0 = time.perf_counter()
        m.update_batch(fr)
        jax.block_until_ready(m.store)
        first = time.perf_counter() - t0
        m.reset()
        t0 = time.perf_counter()
        m.update_batch(fr)
        jax.block_until_ready(m.store)
        wall = time.perf_counter() - t0
        return dict(first_pass_s=first, update_s=wall,
                    frames_per_s=len(fr) / wall, nodes=m.num_nodes)
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _MeshMixin.one_fit_dispatch = old_fit


def query_ab(dims) -> None:
    """map_test end to end with the candidate table vs the window gather,
    on the generated maps."""
    import jax.numpy as jnp
    from gpismap import datasets
    from gpismap.api import _next_pow2
    from gpismap.models import cluster

    for dim in dims:
        fr = frames(dim, 28 if dim == 2 else 8)
        m = new_mapper(dim)
        m.update_batch(fr)
        grid = (datasets.gazebo_test_grid() if dim == 2
                else datasets.bigbird_test_grid())[0]
        xq = np.full((_next_pow2(len(grid)), dim), 1e6, np.float32)
        xq[:len(grid)] = grid
        xq = jnp.asarray(xq)
        m._build_nbrs()
        factors = m._get_factors()

        def run(table):
            return lambda: cluster.map_test(
                m.store, m.grid, xq, factors=factors,
                nbrs=m._nbrs if table else None,
                nbr_dense=m._nbr_dense, **m._test_kwargs())[:4]

        for name, table in [("table", True), ("window", False),
                            ("window", False), ("table", True)]:
            emit(part="nbr_table", dim=dim, variant=name, nq=len(grid),
                 map_test_s=median_time(run(table)))


def gates_ab(dims) -> None:
    """Each path switch's two sides on the frame update."""
    for dim in dims:
        fr = frames(dim, 28 if dim == 2 else 8)
        for variant in ("one", "per_size", "one"):
            emit(part="fit_dispatch", dim=dim, variant=variant,
                 **update_wall(dim, fr, one_fit=variant == "one"))
        if dim != 3:
            continue
        for variant, env in (
                ("compact", {"GPISMAP_OBS_COMPACT": "1"}),
                ("dense_blocked", {"GPISMAP_OBS_COMPACT": "0",
                                   "GPISMAP_OBS_BLOCKED": "1"}),
                ("dense_gather", {"GPISMAP_OBS_COMPACT": "0",
                                  "GPISMAP_OBS_BLOCKED": "0"}),
                ("compact", {"GPISMAP_OBS_COMPACT": "1"})):
            emit(part="obs_path", dim=3, variant=variant,
                 **update_wall(3, fr, env=env))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="query,gates")
    ap.add_argument("--dims", default="2,3")
    ap.add_argument("--out", default="chiprun_out/hopper_ab.json")
    ap.add_argument("--cpu", action="store_true",
                    help="allow a run without a GPU (rehearsal only)")
    args = ap.parse_args()

    dev = _setup.device(args.cpu)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
            if dev.platform == "gpu" else "none")
    emit(part="device", platform=dev.platform, kind=dev.device_kind,
         card=card)
    dims = [int(d) for d in args.dims.split(",")]
    parts = args.only.split(",")
    for name, fn in (("query", query_ab), ("gates", gates_ab)):
        if name in parts:
            t0 = time.perf_counter()
            fn(dims)
            emit(part=f"{name}_done", seconds=time.perf_counter() - t0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(ROWS, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
