#!/usr/bin/env python3
"""Sphere-traced rendering demo: build the 3D map from generated frames,
then render depth/normal images from a camera pose via the differentiable
ray marcher (no grid evaluation, no marching cubes).

Usage: python demos/demo_render.py [--frames N] [--cpu] [--out render.png]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--sub", type=int, default=8)
    ap.add_argument("--out", default="render3d.png")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from gpismap import datasets, render
    from gpismap.api3d import GPisMap3D

    m = GPisMap3D()
    frames = list(datasets.tabletop_frames(0, args.frames))
    for fr in frames:
        m.set_camera(fr.cam_id, "bigbird")
        m.update(fr.depth, fr.pose)
        print(f"frame {fr.frame}: nodes={m.num_nodes}", flush=True)

    # render from the LAST camera pose
    fr = frames[-1]
    tr = fr.pose[:3]
    rot = fr.pose[3:12].reshape(3, 3, order="F")
    t0 = time.time()
    out = render.render_depth(m, tr, rot, subsample=args.sub)
    nrays = out["depth"].size
    print(f"rendered {nrays} rays in {time.time()-t0:.2f}s "
          f"({out['hit'].mean()*100:.1f}% hits)")

    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    im0 = axes[0].imshow(out["depth"], cmap="viridis")
    axes[0].set_title("sphere-traced depth [m]")
    fig.colorbar(im0, ax=axes[0], shrink=0.8)
    nrm = out["normal"] * 0.5 + 0.5
    nrm[~out["hit"]] = 1.0
    axes[1].imshow(np.clip(nrm, 0, 1))
    axes[1].set_title("posterior surface normals")
    im2 = axes[2].imshow(np.where(out["hit"], out["var"], np.nan),
                         cmap="magma")
    axes[2].set_title("SDF variance at hit")
    fig.colorbar(im2, ax=axes[2], shrink=0.8)
    for ax in axes:
        ax.set_xticks([])
        ax.set_yticks([])
    fig.suptitle("gpismap: differentiable sphere tracing of the "
                 "online GPIS map")
    fig.savefig(args.out, dpi=110, bbox_inches="tight")
    print(f"wrote {args.out}")

    # compare rendered depth against the actual sensor depth image
    d_ref = fr.depth[::args.sub, ::args.sub]
    d_est = out["depth"]
    both = out["hit"] & (d_ref > 0.4) & (d_ref < 4.0)
    if both.any():
        err = np.abs(d_est[both] - d_ref[both])
        print(f"depth vs sensor: med {np.median(err)*1000:.1f} mm, "
              f"p95 {np.percentile(err, 95)*1000:.1f} mm over "
              f"{both.sum()} px")


if __name__ == "__main__":
    main()
