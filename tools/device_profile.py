#!/usr/bin/env python3
"""Device-only stage timings for the online update/test loops.

This tool replays a generated sequence to a representative mid-sequence
frame, captures the REAL
arguments of every device dispatch that frame issues (by wrapping the
jitted entry points), then re-times each dispatch amortized over K
back-to-back executions. Dispatches serialize on the single device queue,
so wall/K is a tight upper bound on true device execution time.

The sum of a frame's stages is the device time of one online update
(GPisMap.cpp:151-167 / GPisMap3.cpp:218-237 on the reference's side).

Usage: python tools/device_profile.py 2d|3d [--frame F] [--reps K] [--cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _setup  # noqa: E402



def _drain(out):
    """Wait until the device has finished the result."""
    import jax
    jax.block_until_ready(out)


def _timed(fn, a, k, reps, donate_idx=()):
    import jax

    def args():
        if not donate_idx:
            return a
        # donated args are consumed per call — re-copy them (the copy
        # rides the device queue; timing becomes a slight upper bound)
        return tuple(x.copy() if i in donate_idx else x
                     for i, x in enumerate(a))

    out = fn(*args(), **k)
    jax.block_until_ready(out)
    _drain(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args(), **k)
    _drain(out)
    return (time.time() - t0) / reps


# donated argument positions per function (jit donate_argnums): the
# re-timing loop must re-copy these per call
_DONATED = {"update_factors": (1,), "update_factors_from_l": (0,),
            "frame_finish_full": (14,)}


class _Capture:
    """Swap a module-level jitted function for a capturing wrapper."""

    def __init__(self, mod, name, multi=False):
        self.mod, self.name, self.multi = mod, name, multi
        self.orig = getattr(mod, name)
        self.donate_idx = _DONATED.get(name, ())
        self.calls = []

    def __enter__(self):
        import jax

        def wrapper(*a, **k):
            # don't record calls made while TRACING an outer captured
            # program (e.g. frame_finish_from_mirror inlines
            # scatter_mirror): the args are tracers, not arrays
            if not any(isinstance(x, jax.core.Tracer)
                       for x in jax.tree.leaves((a, k))):
                # donated args are DELETED by the call — snapshot them
                # now so the re-timing loop has live buffers
                a_rec = tuple(
                    x.copy() if i in self.donate_idx else x
                    for i, x in enumerate(a))
                self.calls.append((a_rec, k))
            return self.orig(*a, **k)
        setattr(self.mod, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)

    def time(self, reps):
        """Amortized seconds per frame: each captured call re-timed, then
        summed (a frame may issue several retrain buckets). Captured
        argument pytrees are released as they are timed — holding every
        call's multi-GB factor buffers alive OOMs the 3D profile.
        One-shot: the released args cannot be re-timed."""
        if getattr(self, "_timed_done", False):
            raise RuntimeError(
                f"_Capture({self.name}).time() already consumed its "
                "captured arguments; capture again to re-time")
        self._timed_done = True
        total = 0.0
        n = len(self.calls)
        for i in range(n):
            a, k = self.calls[i]
            self.calls[i] = None
            total += _timed(self.orig, a, k, reps, self.donate_idx)
            del a, k
        self.calls = [None] * n     # len() still reports call count
        return total


def run(mode, frame_i, reps):
    import jax

    from gpismap import datasets
    from gpismap.models import cluster

    if mode == "2d":
        from gpismap.api import GPisMap2D
        from gpismap.models import mapper2d as mapmod
        m = GPisMap2D()
        frames = list(datasets.floor_frames(0))
        step = lambda fr: m.update(fr.thetas, fr.ranges, fr.pose)
        xtest = datasets.gazebo_test_grid()[0]
        stage_caps = [(mapmod, "frame_update_2d")]
    else:
        from gpismap.api3d import GPisMap3D
        from gpismap.models import mapper3d as mapmod
        m = GPisMap3D()
        frames = list(datasets.tabletop_frames(0))

        def step(fr):
            m.set_camera(fr.cam_id, "bigbird")
            m.update(fr.depth, fr.pose)
        xtest = datasets.bigbird_test_grid()[0]
        stage_caps = [(mapmod, "frame_compute_3d"),
                      (mapmod, "reeval_scan_3d"),
                      (mapmod, "reeval_hybrid_3d")]

    frame_i = min(frame_i, len(frames) - 1)
    for fr in frames[:frame_i]:
        step(fr)
        print(f"# replay frame {m.frame - 1}: nodes={m.num_nodes}",
              file=sys.stderr, flush=True)

    caps = [_Capture(mod, name) for mod, name in stage_caps]
    # the full update dispatch set: direct retrain (host-gathered
    # support), mirror-path retrain (support gathered on device from
    # NodeMirror — the default), mirror scatter, device grid rebuild
    caps.append(_Capture(cluster, "retrain_cells"))
    caps.append(_Capture(cluster, "retrain_cells_from_mirror"))
    caps.append(_Capture(cluster, "retrain_cells_from_mirror_with_l"))
    caps.append(_Capture(cluster, "frame_finish_from_mirror"))
    caps.append(_Capture(cluster, "frame_finish_full"))
    caps.append(_Capture(cluster, "scatter_mirror"))
    caps.append(_Capture(cluster, "build_grid_device"))
    t_wall0 = time.time()
    import contextlib
    with contextlib.ExitStack() as st:
        for c in caps:
            st.enter_context(c)
        step(frames[frame_i])
    wall_update = time.time() - t_wall0

    tcaps = [_Capture(cluster, "map_test"),
             _Capture(cluster, "factorize_slots"),
             _Capture(cluster, "build_neighbor_table")]
    t_wall0 = time.time()
    with contextlib.ExitStack() as st:
        for c in tcaps:
            st.enter_context(c)
        m.test(xtest)
    wall_test = time.time() - t_wall0

    # time the captured update/test stages BEFORE the steady-state step:
    # its factor refresh DONATES the cache buffer the captured map_test
    # call still references (replaying it afterwards hits a deleted
    # buffer)
    stages = {}
    for c in caps + tcaps:
        if c.calls:
            stages[c.name] = {"calls": len(c.calls),
                              "device_ms": round(c.time(reps) * 1e3, 3)}

    # steady-state online frame: update with the factor cache warm (the
    # incremental update_factors path) then a cache-hit test
    scaps = [_Capture(cluster, "update_factors"),
             _Capture(cluster, "update_factors_from_l"),
             _Capture(cluster, "frame_finish_full"),
             _Capture(cluster, "map_test")]
    if frame_i + 1 < len(frames):
        with contextlib.ExitStack() as st:
            for c in scaps:
                st.enter_context(c)
            step(frames[frame_i + 1])
            m.test(xtest)
    steady = {}
    for c in scaps:
        if c.calls:
            steady[c.name] = {"calls": len(c.calls),
                              "device_ms": round(c.time(reps) * 1e3, 3)}

    test_keys = ("map_test", "factorize_slots", "build_neighbor_table")
    upd_ms = sum(v["device_ms"] for k, v in stages.items()
                 if k not in test_keys)
    test_ms = sum(v["device_ms"] for k, v in stages.items()
                  if k in test_keys)
    out = {
        "mode": mode,
        "frame": frame_i,
        "n_nodes": int(m.num_nodes),
        "reps": reps,
        "device": jax.devices()[0].device_kind,
        "stages": stages,
        "device_update_ms_per_frame": round(upd_ms, 3),
        "device_update_fps": round(1e3 / upd_ms, 1) if upd_ms else None,
        "device_test_ms": round(test_ms, 3),
        "device_test_qps": round(len(xtest) / (test_ms / 1e3), 1)
        if test_ms else None,
        "n_test_points": int(len(xtest)),
        "wall_update_s": round(wall_update, 3),
        "wall_test_s": round(wall_test, 3),
        "steady_state": steady,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["2d", "3d"])
    ap.add_argument("--frame", type=int, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    _setup.device(args.cpu)
    frame = args.frame if args.frame is not None else (
        14 if args.mode == "2d" else 20)
    run(args.mode, frame, args.reps)
