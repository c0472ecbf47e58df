#!/usr/bin/env python3
"""2D demo: online mapping of the generated floor-plan LiDAR sequence.

Python equivalent of matlab/demo_gpisMap.m + visualize_gpisMap.m: maps the
28 generated scans (gpismap.datasets.floor_frames), evaluates the SDF field
on the 49,551-point grid, and renders the field + variance-filtered
surface contour.

Usage: python demos/demo_2d.py [--frames N] [--cpu] [--out demo2d.png]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="demo2d.png")
    ap.add_argument("--every", type=int, default=0,
                    help="re-render the field every K frames (the "
                    "reference demo loop draws each frame, "
                    "demo_gpisMap.m:54-57); writes <out>_f<NNN>.png")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from gpismap import datasets, viz
    from gpismap.api import GPisMap2D

    m = GPisMap2D()
    frames = list(datasets.floor_frames(0, args.frames or 28))

    xtest, shape = datasets.gazebo_test_grid()

    def draw(res, fr, path, n_done):
        fig, ax = plt.subplots(figsize=(10, 8))
        valid = (fr.ranges > 0.2) & (fr.ranges < 30.0)
        rot = fr.pose[2:6].reshape(2, 2, order="F")
        loc = np.stack([fr.ranges * np.cos(fr.thetas),
                        fr.ranges * np.sin(fr.thetas)], -1) + [0.08, 0.0]
        scan = loc[valid] @ rot.T + fr.pose[:2]
        pc = viz.plot_field_2d(ax, res, xtest, shape, scan_xy=scan,
                               pose=fr.pose)
        fig.colorbar(pc, ax=ax, label="SDF [m]")
        ax.set_title(f"gpismap 2D — {n_done} frames, "
                     f"{m.num_nodes} surface nodes")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        print(f"wrote {path}")

    stem, ext = os.path.splitext(args.out)
    for i, fr in enumerate(frames):
        t0 = time.time()
        m.update(fr.thetas, fr.ranges, fr.pose)
        print(f"frame {fr.frame}: nodes={m.num_nodes} "
              f"update={time.time()-t0:.2f}s", flush=True)
        if args.every and (i + 1) % args.every == 0:
            # the reference demo's per-frame field redraw
            draw(m.test(xtest), fr, f"{stem}_f{i:03d}{ext or '.png'}",
                 i + 1)
    t0 = time.time()
    res = m.test(xtest)
    print(f"test: {len(xtest)} pts in {time.time()-t0:.2f}s")
    draw(res, frames[-1], args.out, len(frames))


if __name__ == "__main__":
    main()
