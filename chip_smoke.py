#!/usr/bin/env python3
"""Smoke run of the mappers on an NVIDIA GPU, through the public API.

    python chip_smoke.py              # one card
    python chip_smoke.py --chips 4    # the sharded mappers over four cards

One card: GPisMap2D (28 generated LiDAR frames, then the 49,551-point
grid) and GPisMap3D (8 generated 640x480 depth frames, then the
15,225-point volume grid) end to end; a forward+backward render; the tile
evaluation as compiled for the card against a float64 oracle at the
production widths; and the whole pipeline re-run on the host CPU in the
same process (all 28 frames in 2D, 4 in 3D) and compared with the GPU's
query output at the repository's parity bounds.

--chips 4: GPisMap2D and GPisMap3D over a 4-GPU mesh on generated frames,
compared with the one-card run of the same frames.

Every phase either passes or raises; the last line of standard output is
{"ok": true, "device": {...}} only when all of them passed. With no GPU
the script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_FRAMES_2D = 28
N_FRAMES_3D = 8
N_FRAMES_3D_CPU = 4
# the repository's parity bounds (tests/test_parallel.py)
MAPPED_AGREEMENT = 0.995
MEDIAN_DF = 2e-3
P95_DF = 2e-2
# the tile evaluation vs the float64 oracle. A variance is
# const - ||L^-1 k*||^2 with const = val_const (~1) or grad_const
# (3/l^2 + c: 2.2 in 2D, 1875 in 3D), so its float32 rounding scales with
# const: the variance bound applies to |dvar| / max(1, const).
ORACLE_TOL_FG = 1e-3
ORACLE_TOL_VAR = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    """Name and power limit of every card, from nvidia-smi (a child
    process that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def require_gpu(count: int):
    """The devices JAX sees; exits non-zero unless they are GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}")
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX found {len(devs)}")
    return devs


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

def frames_2d(n: int):
    from gpismap import datasets
    return [(fr.thetas, fr.ranges, fr.pose)
            for fr in datasets.floor_frames(SEED, n)]


def frames_3d(n: int):
    from gpismap import datasets
    return [(fr.depth, fr.pose, fr.cam_id)
            for fr in datasets.tabletop_frames(SEED, n)]


def run_2d(frames, mesh=None):
    from gpismap import GPisMap2D, datasets
    m = GPisMap2D(mesh=mesh)
    _, t_upd = timed(m.update_batch, frames)
    grid, _ = datasets.gazebo_test_grid()
    res, t_test = timed(m.test, grid)
    return m, res, t_upd, t_test


def run_3d(frames, mesh=None):
    from gpismap import GPisMap3D, datasets
    m = GPisMap3D(mesh=mesh)
    _, t_upd = timed(m.update_batch, frames)
    grid, _ = datasets.bigbird_test_grid()
    res, t_test = timed(m.test, grid)
    return m, res, t_upd, t_test


def surface_points_2d(frames, k: int = 4000):
    """Observed hit points (on the true walls up to the range noise)."""
    from gpismap.config import MAPPER_2D
    pts = []
    off = np.asarray(MAPPER_2D.sensor_offset)
    for th, rg, pose in frames:
        ok = (rg > MAPPER_2D.min_range) & (rg < MAPPER_2D.max_range)
        rot = pose[2:6].reshape(2, 2, order="F")
        loc = np.stack([rg * np.cos(th), rg * np.sin(th)], -1) + off
        pts.append((loc @ rot.T + pose[:2])[ok])
    pts = np.concatenate(pts)
    return pts[np.random.default_rng(SEED).choice(len(pts), k)]


def surface_points_3d(frames, k: int = 4000):
    from gpismap.config import BIGBIRD_CAMS, MAPPER_3D
    pts = []
    for depth, pose, cid in frames:
        cam = BIGBIRD_CAMS[cid - 1]
        v, u = np.mgrid[0:cam.height:4, 0:cam.width:4]
        z = depth[::4, ::4]
        ok = (z > MAPPER_3D.min_range) & (z < MAPPER_3D.max_range)
        loc = np.stack([(u - cam.cx) / cam.fx * z,
                        (v - cam.cy) / cam.fy * z, z], -1)[ok]
        rot = pose[3:12].reshape(3, 3, order="F")
        pts.append(loc @ rot.T + pose[:3])
    pts = np.concatenate(pts)
    return pts[np.random.default_rng(SEED).choice(len(pts), k)]


def check_result(name: str, res: np.ndarray, n: int, d: int) -> None:
    assert res.shape == (n, 2 + 2 * d), (name, res.shape)
    assert np.isfinite(res).all(), f"{name}: non-finite query output"
    mapped = res[:, 1 + d] < 1.0
    assert mapped.any(), f"{name}: nothing mapped"
    log(f"{name}: {n} queries, mapped {mapped.mean():.4f}")


def surface_sanity(name: str, m, pts, sdf) -> None:
    res = m.test(pts)
    log(f"{name}: median |f + fbias| at {len(pts)} observed surface points "
        f"{np.median(np.abs(res[:, 0] + m.p.fbias)):.5f} m "
        f"(analytic |sdf| there {np.median(np.abs(sdf(pts))):.5f} m)")


def compare_fields(name: str, ref: np.ndarray, res: np.ndarray,
                   d: int) -> None:
    """Mapped agreement and |df| over the points both runs map."""
    vcol = 1 + d
    mapped_ref = ref[:, vcol] < 1.0
    mapped = res[:, vcol] < 1.0
    agree = float((mapped_ref == mapped).mean())
    both = mapped_ref & mapped
    df = np.abs(res[both, 0] - ref[both, 0])
    med, p95 = float(np.median(df)), float(np.percentile(df, 95))
    log(f"{name}: mapped agreement {agree:.5f}, median |df| {med:.2e}, "
        f"p95 |df| {p95:.2e} over {int(both.sum())} points")
    assert agree > MAPPED_AGREEMENT, f"{name}: agreement {agree}"
    assert med < MEDIAN_DF, f"{name}: median |df| {med}"
    assert p95 < P95_DF, f"{name}: p95 |df| {p95}"


# ---------------------------------------------------------------------------
# query numerics at the production widths
# ---------------------------------------------------------------------------

def check_tile_eval(name: str, m, n_cells: int = 3) -> None:
    """The tile evaluation as compiled for the card
    (cluster._ongpis_eval_tile, matmuls at ops/precision.MATMUL) vs the
    float64 oracle on a sample of the map's cells, one tile of T queries
    each: a TF32 contraction would show here."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import naive_oracle
    from gpismap.models import cluster

    factors = m._get_factors()
    assert factors is not None, f"{name}: live cells exceed the factor cache"
    linv_buf, uniq = factors
    big = np.iinfo(np.int32).max
    uniq_h = np.asarray(uniq)
    slot_of = jnp.asarray(np.where(uniq_h < big, uniq_h, -1), jnp.int32)
    live = np.nonzero(uniq_h < big)[0].astype(np.int32)
    t, d = m.cap.test_tile, m.dim
    kw = m._test_kwargs()
    store = jax.device_get(m.store)
    rng = np.random.default_rng(SEED)
    cells = rng.choice(live, min(n_cells, len(live)), replace=False)
    q = np.zeros((len(cells), t, d), np.float32)
    for g, c in enumerate(cells):
        s = uniq_h[c]
        xs = store.x[s][store.valid[s]]
        base = xs[rng.integers(0, len(xs), t)]
        q[g] = base + rng.uniform(-1, 1, (t, d)) * kw["search_half"]
    out = jax.jit(cluster._ongpis_eval_tile)(
        m.store, linv_buf, slot_of, jnp.asarray(cells), jnp.asarray(q),
        kw["scale"], kw["val_const"], kw["grad_const"])
    got = [np.asarray(a) for a in out]
    scale = (1.0, 1.0, max(1.0, kw["val_const"]),
             max(1.0, kw["grad_const"]))
    for g, c in enumerate(cells):
        s = uniq_h[c]
        v = store.valid[s]
        ref = naive_oracle.ongpis_fit_test(
            store.x[s][v].astype(np.float64),
            store.grad[s][v].astype(np.float64),
            store.val[s][v].astype(np.float64),
            store.sigx[s][v].astype(np.float64),
            store.siggrad[s][v].astype(np.float64), kw["scale"],
            q[g].astype(np.float64), kw["val_const"], kw["grad_const"])
        e = [float(np.max(np.abs(a - b[g]))) for a, b in zip(ref, got)]
        log(f"{name} tile evaluation vs float64 oracle, cell {s} "
            f"({int(v.sum())} nodes, MP={linv_buf.shape[-1]}, T={t}): "
            f"max|df| {e[0]:.2e} max|dg| {e[1]:.2e} max|dvf| {e[2]:.2e} "
            f"max|dvg| {e[3]:.2e} (grad_const {kw['grad_const']:.1f})")
        rel = [x / c for x, c in zip(e, scale)]
        assert max(rel[0], rel[1]) <= ORACLE_TOL_FG, e
        assert max(rel[2], rel[3]) <= ORACLE_TOL_VAR, e


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def memory_report(m, frame) -> None:
    """compiled.memory_analysis() of the 3D frame program, and the
    device's peak bytes in use so far."""
    import jax
    from gpismap.models import mapper3d

    depth, pose, cid = frame
    m.set_camera(cid)
    nv, _ = m._host_gate(depth)
    tr, rot = pose[:3], pose[3:12].reshape(3, 3, order="F")
    lowered = mapper3d.frame_compute_3d.lower(
        *m._dev_batch((depth, tr, rot)), m.cam, m.p, m.op,
        nv_cap=m._obs_nv_cap(nv), obs_c_cap=m._obs_cell_cap(
            m._last_valid_mask))
    ma = lowered.compile().memory_analysis()
    log(f"frame_compute_3d memory_analysis: {ma}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"device peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def render_phase(m) -> None:
    """Forward sphere trace + backward through the implicit correction
    (the query's custom-gradient path) on the 3D map."""
    import jax
    import jax.numpy as jnp
    from gpismap import datasets, render
    from gpismap.config import BIGBIRD_CAMS

    fr = next(datasets.tabletop_frames(SEED + 1, 1))
    cam = BIGBIRD_CAMS[fr.cam_id - 1]
    rot = fr.pose[3:12].reshape(3, 3, order="F")
    o, dirs, _ = render.camera_rays(fr.pose[:3], rot, cam, subsample=16)
    cfg = render.config_from_mapper(m)
    factors = m._get_factors()
    o, dirs = jnp.asarray(o), jnp.asarray(dirs)

    def loss(alpha):
        out = render.sphere_trace(m.store._replace(alpha=alpha), m.grid,
                                  o, dirs, cfg, factors)
        return jnp.sum(jnp.where(out["hit"], out["t"], 0.0)), out

    vg = jax.value_and_grad(loss, has_aux=True)
    ((_, out), grad), t_r = timed(lambda: jax.block_until_ready(
        vg(m.store.alpha)))
    hit = np.asarray(out["hit"])
    g = np.asarray(grad)
    log(f"render: {len(hit)} rays, hit {hit.mean():.3f}, "
        f"|d loss/d alpha| {np.abs(g).sum():.3e} (first call incl. "
        f"compile {t_r:.1f} s)")
    assert hit.any(), "render: no ray hit the surface"
    assert np.isfinite(np.asarray(out["t"])).all()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0


def one_card() -> None:
    import jax
    from gpismap import datasets

    f2 = frames_2d(N_FRAMES_2D)
    m2, r2, tu, tt = run_2d(f2)
    log(f"2D GPU: {len(f2)} frames in {tu:.1f} s, {m2.num_nodes} nodes; "
        f"grid query {tt:.2f} s (both incl. compile)")
    check_result("2D GPU", r2, len(datasets.gazebo_test_grid()[0]), 2)
    surface_sanity("2D GPU", m2, surface_points_2d(f2),
                   datasets.floor_plan_sdf)
    check_tile_eval("2D", m2)

    f3 = frames_3d(N_FRAMES_3D)
    m3, r3, tu, tt = run_3d(f3)
    log(f"3D GPU: {len(f3)} frames in {tu:.1f} s, {m3.num_nodes} nodes; "
        f"grid query {tt:.2f} s (both incl. compile)")
    check_result("3D GPU", r3, len(datasets.bigbird_test_grid()[0]), 3)
    surface_sanity("3D GPU", m3, surface_points_3d(f3),
                   datasets.tabletop_sdf)
    check_tile_eval("3D", m3)
    memory_report(m3, f3[-1])
    render_phase(m3)

    # the same frames pinned to the host CPU, in this process
    m3g, r3g, _, _ = run_3d(f3[:N_FRAMES_3D_CPU])
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        m2c, r2c, tu, tt = run_2d(f2)
        log(f"2D CPU: {len(f2)} frames in {tu:.1f} s, {m2c.num_nodes} "
            f"nodes; grid query {tt:.2f} s")
        m3c, r3c, tu, tt = run_3d(f3[:N_FRAMES_3D_CPU])
        log(f"3D CPU: {N_FRAMES_3D_CPU} frames in {tu:.1f} s, "
            f"{m3c.num_nodes} nodes; grid query {tt:.2f} s")
    assert next(iter(m2c.store.x.devices())).platform == "cpu"
    compare_fields("2D GPU vs CPU", r2c, r2, 2)
    compare_fields("3D GPU vs CPU", r3c, r3g, 3)


def four_cards(devs) -> None:
    """The sharded mappers over a 4-GPU mesh vs one card, same frames."""
    from gpismap.api import _next_pow2
    from gpismap.parallel import data_mesh

    mesh = data_mesh(devs[:4])
    for dim, frames, run in ((2, frames_2d(12), run_2d),
                             (3, frames_3d(4), run_3d)):
        m1, r1, tu1, tt1 = run(frames)
        m4, r4, tu4, tt4 = run(frames, mesh=mesh)
        log(f"{dim}D: one card {tu1:.1f} s update / {tt1:.2f} s query, "
            f"4-card mesh {tu4:.1f} s / {tt4:.2f} s (incl. compile); "
            f"nodes {m1.num_nodes} vs {m4.num_nodes}")
        xq = m4._dev(np.zeros((_next_pow2(len(r4)), dim), np.float32),
                     shard=True)     # the padded batch test() shards
        log(f"{dim}D query batch shards: " + ", ".join(
            f"{s.device}: {s.data.shape}" for s in xq.addressable_shards))
        assert len({s.device for s in xq.addressable_shards}) == 4
        assert m1.num_nodes == m4.num_nodes
        np.testing.assert_allclose(r4, r1, rtol=1e-4, atol=5e-4)
        log(f"{dim}D 4-card vs one card: max |diff| "
            f"{float(np.max(np.abs(r4 - r1))):.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    devs = require_gpu(args.chips)
    from gpismap.runtime.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    kind = devs[0].device_kind
    log(f"device: {kind} x{len(devs)} ({devs[0].platform}); "
        f"compile cache {cache}")
    log(f"card (name, power limit): {card_info()}")
    t0 = time.perf_counter()
    if args.chips == 4:
        four_cards(devs)
    else:
        one_card()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"card (name, power limit): {card_info()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": kind,
        "count": args.chips}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
