#!/usr/bin/env python3
"""3D demo: online mapping of the generated table-top depth sequence.

Python equivalent of matlab/demo_gpisMap3.m + visualize_gpisMap3.m: maps
the 40 generated frames (gpismap.datasets.tabletop_frames) with per-frame
camera selection, evaluates the volume grid, extracts the isosurface and
re-queries vertex variances for the alpha channel.

Usage: python demos/demo_3d.py [--frames N] [--cpu] [--out demo3d.png]
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
    ap.add_argument("--out", default="demo3d.png")
    ap.add_argument("--no-slices", action="store_true",
                    help="skip the two oblique SDF slice planes "
                    "(visualize_gpisMap3.m:53-82)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from gpismap import datasets, viz
    from gpismap.api3d import GPisMap3D

    m = GPisMap3D()
    frames = list(datasets.tabletop_frames(0, args.frames or 40))

    for fr in frames:
        t0 = time.time()
        m.set_camera(fr.cam_id, "bigbird")
        m.update(fr.depth, fr.pose)
        print(f"frame {fr.frame} cam {fr.cam_id}: nodes={m.num_nodes} "
              f"update={time.time()-t0:.2f}s", flush=True)

    xtest, shape = datasets.bigbird_test_grid()
    t0 = time.time()
    res = m.test(xtest)
    print(f"test: {len(xtest)} pts in {time.time()-t0:.2f}s")

    verts, faces = viz.extract_surface_3d(res, xtest, shape)
    print(f"isosurface: {len(verts)} verts, {len(faces)} faces")
    vertex_var = None
    if len(verts):
        vres = m.test(verts.astype(np.float32))
        vertex_var = vres[:, 4]

    fig = plt.figure(figsize=(9, 8))
    ax = fig.add_subplot(111, projection="3d")
    viz.plot_surface_3d(ax, verts, faces, vertex_var)
    if not args.no_slices:
        planes = viz.slice_planes_3d()
        slice_res = [m.test(pts) for pts, _ in planes]
        mp = viz.plot_slices_3d(ax, planes, slice_res)
        fig.colorbar(mp, ax=ax, shrink=0.6, label="SDF [m]")
        ax.set_xlim(-0.09, 0.17)
        ax.set_ylim(-0.13, 0.17)
        ax.set_zlim(0.0, 0.30)
        ax.view_init(elev=30, azim=-30)
    ax.set_title(f"gpismap 3D — {len(frames)} frames, "
                 f"{m.num_nodes} surface nodes")
    fig.savefig(args.out, dpi=110, bbox_inches="tight")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
