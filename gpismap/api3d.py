"""GPisMap3D — online 3D SDF mapper from depth images.

Mirrors the reference command surface (update/test/reset/setCamera/
getAllPoints; reference: cpp/include/GPisMap3.h:124-133 and
mex/mexGPisMap3.cpp:111-157).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .api import _MeshMixin, _default_buckets, _next_pow2, _retrain_store
from .config import (BIGBIRD_CAMS, CAPACITY_3D, MAPPER_3D, OBSGP_2D,
                     TREE_3D, YCB_CAMS, CameraParam, CapacityParam,
                     MapperParam, ObsGPParam, TreeParam)
from .models import cluster, mapper3d
from .runtime import SpatialIndex


def _obs_compact() -> bool:
    """Compacted ObsGP2D fit and probe sweep (_obs_nv_cap,
    _obs_cell_cap) or the dense ones. The default was chosen on the H100
    (CHANGES.md); GPISMAP_OBS_COMPACT=0/1 overrides."""
    import os
    return os.environ.get("GPISMAP_OBS_COMPACT", "1") not in ("0", "off")


class GPisMap3D(_MeshMixin):
    """Online continuous 3D SDF mapper.

    update(depth, pose12) ingests one [H, W] depth image (meters) with pose
    [t(3), R column-major(9)] (mexGPisMap3.cpp convention); test(x)
    returns [N, 8] = [f, gx, gy, gz, var_f, var_gx, var_gy, var_gz]
    (mexGPisMap3.cpp:96-99).

    Pass `mesh` to run queries/re-evaluation/retrain SPMD over multiple
    devices (see api._MeshMixin).
    """

    def __init__(self, params: MapperParam = MAPPER_3D,
                 obs_param: ObsGPParam = OBSGP_2D,
                 tree: TreeParam = TREE_3D,
                 cap: CapacityParam = CAPACITY_3D,
                 camera: Optional[CameraParam] = None,
                 compat_reloc: bool = True,
                 strict_reeval: bool = True,
                 reeval_mode: Optional[str] = None,
                 mesh=None):
        self.p = params
        self.op = obs_param
        self.tp = tree
        self.cap = cap
        self.dim = 3
        self.cam = camera or CameraParam()
        self.compat_reloc = compat_reloc
        # Re-evaluation scheduling. In 3D the relocation step is comparable
        # to the 0.05 m cluster size, so nodes cross cell boundaries often
        # enough that snapshot batching visibly shifts the node set —
        # strict per-cell order matters. Modes:
        #   'hybrid'  (default) — strict-order semantics as one vectorized
        #             pass + mover fix-up rounds (mapper3d.reeval_hybrid_3d;
        #             observably equal to 'fused' at a fraction of the
        #             sequential depth).
        #   'fused'   — strict per-cell order executed as ONE lax.scan
        #             device program (mapper3d.reeval_scan_3d); tree
        #             mutations applied on host at frame end.
        #   'strict'  — exact host replay: one dispatch per kept cell,
        #             interleaved tree mutation (the bit-exact parity mode).
        #   'snapshot'— single-batch re-evaluation of a start-of-frame
        #             snapshot (the 2D default; fastest, loosest).
        if reeval_mode is None:
            reeval_mode = "hybrid" if strict_reeval else "snapshot"
        if reeval_mode not in ("strict", "fused", "hybrid", "snapshot"):
            raise ValueError(f"unknown reeval_mode {reeval_mode!r}")
        self.reeval_mode = reeval_mode
        self.strict_reeval = reeval_mode != "snapshot"
        self._init_mesh(mesh)
        self.index = SpatialIndex(self.dim, tree, max_slots=cap.max_cells)
        self.store = self._dev(cluster.make_store(cap, self.dim))
        self.cell_size = 2.0 * tree.cluster_halfleng
        self.grid_half = int(round(2.0 * tree.max_halfleng / self.cell_size))
        self.grid = self._dev(cluster.build_grid(np.zeros((0, 3), np.int64),
                                                 np.zeros(0, np.int32), 3,
                                                 self.grid_half))
        # test search box: C_leng * 3 (GPisMap3.cpp:811)
        self._search_half = tree.cluster_halfleng * 3.0
        self._noff = int((self._search_half + self.cell_size)
                         / self.cell_size)
        self.frame = 0
        self.stats: dict = {}
        self._factors = None   # cached per-cell Cholesky factors
        self._factors_slots = None
        self._nbrs = None      # cached candidate table (NeighborTable)
        self._nbr_dense = False
        self._mirror = None    # device node-table mirror (NodeMirror)
        self._retrain_buckets = _default_buckets(cap.gp_support)

    # ------------------------------------------------------------------
    def set_camera(self, cam_id_or_param, family: str = "bigbird"):
        """Select intrinsics (mexGPisMap3.cpp:111-144): either a 1-based
        camera id into the bigbird/YCB tables, or a CameraParam."""
        if isinstance(cam_id_or_param, CameraParam):
            self.cam = cam_id_or_param
        else:
            table = BIGBIRD_CAMS if family == "bigbird" else YCB_CAMS
            self.cam = table[int(cam_id_or_param) - 1]

    def reset(self):
        self.index.reset()
        self.store = self._dev(cluster.make_store(self.cap, self.dim))
        self.grid = self._dev(cluster.build_grid(np.zeros((0, 3), np.int64),
                                                 np.zeros(0, np.int32), 3,
                                                 self.grid_half))
        self.frame = 0
        self._factors = None
        self._factors_slots = None
        self._nbrs = None
        self._mirror = None

    # ------------------------------------------------------------------
    def _obs_limits(self):
        """Image-plane visibility bounds (GPisMap3.cpp:169-172)."""
        skip = self.p.obs_skip
        m = self.cam.height // skip
        n = self.cam.width // skip
        u_lim = (-self.cam.cx / self.cam.fx,
                 ((n - 1) * skip - self.cam.cx) / self.cam.fx)
        v_lim = (-self.cam.cy / self.cam.fy,
                 ((m - 1) * skip - self.cam.cy) / self.cam.fy)
        return u_lim, v_lim

    def update(self, depth: np.ndarray, pose: np.ndarray) -> None:
        """Ingest one depth frame (GPisMap3::update, GPisMap3.cpp:218-237).
        """
        import time as _time
        _t0 = _time.time()
        depth = np.asarray(depth, np.float32)
        pose = np.asarray(pose, np.float32).reshape(-1)
        tr = pose[:3]
        rot = pose[3:12].reshape(3, 3, order="F")

        # host-side range gate: (nv, rmax) without a device pull, and nv's
        # pow2 bucket routes the probe sweep through the compacted gather
        # path (mapper3d.newmeas_3d nv_cap)
        nv, rmax = self._host_gate(depth)
        if nv <= 1:
            return
        # depth stays replicated (the grid-partitioned obs fit is global);
        # the sharded axes are re-evaluated nodes, retrain cells, queries
        prep, obs, nm = mapper3d.frame_compute_3d(
            self._dev(depth), self._dev(tr), self._dev(rot), self.cam,
            self.p, self.op, nv_cap=self._obs_nv_cap(nv),
            obs_c_cap=self._obs_cell_cap(self._last_valid_mask))
        # ONE blocking pull for everything update() needs on host
        nm = jax.device_get(nm)

        self._update_map_points(obs, float(rmax), tr, rot)

        self._apply_newmeas(nm)

        _t1 = _time.time()
        self._update_gps()
        self.stats.update(
            frame=self.frame, n_nodes=self.index.num_nodes,
            n_cluster_cells=int(self.index.max_slot),
            support_overflow=int(self.index.overflow_count),
            update_s=round(_time.time() - _t0, 4),
            retrain_s=round(_time.time() - _t1, 4))
        self.frame += 1

    def _obs_nv_cap(self, nv: int):
        """pow2 bucket (floor 1024) of the frame's valid-pixel count for
        the compacted probe sweep (mapper3d.newmeas_3d nv_cap): a depth
        frame gates out most pixels, so the dense sweep evaluates many
        more ObsGP posteriors than needed. None selects the dense sweep.
        The default was chosen on the H100 (CHANGES.md);
        GPISMAP_OBS_COMPACT=0/1 overrides. Bucketing limits recompiles
        (each new bucket is a fresh frame_compute_3d compile)."""
        if not _obs_compact():
            return None
        return max(1024, _next_pow2(nv))

    def _host_gate(self, depth: np.ndarray):
        """Host replica of preprocess_3d's range gate (GPisMap3.cpp:176-210)
        so the batch path needs no device pull for (n_valid, rmax)."""
        skip = self.p.obs_skip
        mrow = self.cam.height // skip
        ncol = self.cam.width // skip
        z = depth[::skip, ::skip][:mrow, :ncol].astype(np.float32)
        valid = (z > self.p.min_range) & (z < self.p.max_range)
        rmax = float(np.max(np.where(valid, z, 0.0)))
        self._last_valid_mask = valid
        return int(valid.sum()), rmax

    def _obs_cell_cap(self, valid: np.ndarray):
        """pow2 bucket (floor 256) of the number of NONEMPTY obs cells —
        cells whose (overlapping) pixel window contains a range-gated
        pixel (the exact `trained` predicate of fit_obsgp2d, computed
        from the static partition + the host valid mask via an integral
        image). Gates the compacted fit; same switch as the compacted
        probe sweep (_obs_compact)."""
        from .models import obsgp
        if not _obs_compact():
            return None
        m, n = valid.shape
        ii = np.zeros((m + 1, n + 1), np.int64)
        ii[1:, 1:] = np.cumsum(np.cumsum(valid, 0), 1)
        gs, ov = self.op.group_size, self.op.overlap
        _, i0s, i1s, _ = obsgp.partition_1axis(m, gs, ov)
        _, j0s, j1s, _ = obsgp.partition_1axis(n, gs, ov)
        i0 = np.asarray(i0s)[:, None]
        i1 = np.asarray(i1s)[:, None] + 1
        j0 = np.asarray(j0s)[None, :]
        j1 = np.asarray(j1s)[None, :] + 1
        cnt = ii[i1, j1] - ii[i0, j1] - ii[i1, j0] + ii[i0, j0]
        nonempty = int((cnt > 0).sum())
        return max(256, _next_pow2(max(nonempty, 1)))

    def update_batch(self, frames) -> None:
        """Pipelined multi-frame ingestion (see GPisMap2D.update_batch).

        frames: iterable of (depth, pose12) or (depth, pose12, cam) with
        cam a CameraParam or 1-based bigbird camera id. Every frame's
        tree-independent program (frame_compute_3d: preprocess + ObsGP2D
        fit + new-measurement evaluation) is dispatched up front; the
        per-frame blocking pull fetches the fused re-evaluation AND the
        new-measurement results together, so device compute overlaps the
        host tree replay. Supported for the default 'fused'
        re-evaluation mode; 'strict' falls back to per-frame update().
        """
        import time as _time
        frames = list(frames)
        if self.reeval_mode == "strict":
            for f in frames:
                if len(f) > 2:
                    self.set_camera(f[2])
                self.update(f[0], f[1])
            return
        pend = []
        for f in frames:
            if len(f) > 2:
                self.set_camera(f[2])
            depth = np.asarray(f[0], np.float32)
            pose = np.asarray(f[1], np.float32).reshape(-1)
            tr = pose[:3]
            rot = pose[3:12].reshape(3, 3, order="F")
            nv, rmax = self._host_gate(depth)
            if nv <= 1:
                pend.append(None)
                continue
            dep_d, tr_d, rot_d = self._dev_batch((depth, tr, rot))
            prep, obs, nm = mapper3d.frame_compute_3d(
                dep_d, tr_d, rot_d, self.cam, self.p, self.op,
                nv_cap=self._obs_nv_cap(nv),
                obs_c_cap=self._obs_cell_cap(self._last_valid_mask))
            pend.append((tr, rot, rmax, obs, nm))

        for item in pend:
            if item is None:
                continue
            _t0 = _time.time()
            tr, rot, rmax, obs, nm = item
            kept = self._cull_cells(rmax, tr, rot)
            disp = (self._dispatch_reeval_fused(obs, kept, tr, rot)
                    if len(kept) else None)
            p_nm = nm.insert_ok.shape[0]
            # ONE blocking pull per frame, ONE pytree leaf
            # (mapper3d.pack_frame_results)
            if disp is not None:
                node_ids, rv, drop = disp
                k_rv = rv.action.shape[0]
                flat = jax.device_get(
                    mapper3d.pack_frame_results(rv, drop, nm))
                rv, drop, nm = mapper3d.unpack_frame_results(
                    flat, k_rv, p_nm)
                self._apply_reeval_fused(node_ids, rv, drop)
            else:
                flat = jax.device_get(mapper3d.pack_nm_only(nm))
                _, _, nm = mapper3d.unpack_frame_results(flat, 0, p_nm)
            self._apply_newmeas(nm)
            _t1 = _time.time()
            self._update_gps()
            self.stats.update(
                frame=self.frame, n_nodes=self.index.num_nodes,
                n_cluster_cells=int(self.index.max_slot),
                support_overflow=int(self.index.overflow_count),
                update_s=round(_time.time() - _t0, 4),
                retrain_s=round(_time.time() - _t1, 4))
            self.frame += 1

    # ------------------------------------------------------------------
    def _cull_cells(self, rmax: float, tr, rot) -> np.ndarray:
        """Range + frustum cell culls (GPisMap3.cpp:276-301)."""
        if self.index.num_nodes == 0:
            return np.zeros(0, np.int32)
        cells, _ = self.index.query_cluster_cells(tr, rmax, cap=65536)
        if len(cells) == 0:
            return cells
        centers, halfs, _ = self.index.cell_info(cells)
        sqr = np.sum((centers - tr) ** 2, -1)
        keep = sqr <= rmax * rmax + 2.0 * halfs * halfs
        # frustum cull by corners; the reference overwrites within_angle
        # per z>0 corner so only the LAST front corner decides
        # (GPisMap3.cpp:289-301) — replicated.
        signs = np.array([[-1, 1, 1], [1, 1, 1], [-1, -1, 1], [1, -1, 1],
                          [-1, 1, -1], [1, 1, -1], [-1, -1, -1],
                          [1, -1, -1]], np.float32)
        corners = centers[:, None, :] + halfs[:, None, None] * signs
        loc = (corners - tr) @ rot                     # [C, 8, 3]
        u_lim, v_lim = self._obs_limits()
        z = loc[..., 2]
        front = z > 0
        xv = loc[..., 0] / np.where(front, z, 1.0)
        yv = loc[..., 1] / np.where(front, z, 1.0)
        vis = ((xv > u_lim[0]) & (xv < u_lim[1])
               & (yv > v_lim[0]) & (yv < v_lim[1]))
        within = np.zeros(len(cells), bool)
        for c in range(8):                             # replay overwrite
            within = np.where(front[:, c], vis[:, c], within)
        keep &= within
        return cells[keep]

    def _update_map_points(self, obs, rmax: float, tr, rot):
        kept = self._cull_cells(rmax, tr, rot)
        if len(kept) == 0:
            return
        if self.reeval_mode == "strict":
            for c in kept:
                self._reeval_apply(obs, self.index.cell_nodes(c), tr, rot)
        elif self.reeval_mode in ("fused", "hybrid"):
            self._reeval_fused(obs, kept, tr, rot)
        else:
            node_ids = [self.index.cell_nodes(c) for c in kept]
            node_ids = np.concatenate(node_ids) if node_ids else np.zeros(
                0, np.int32)
            self._reeval_apply(obs, node_ids, tr, rot)

    def _dispatch_reeval_fused(self, obs, kept, tr, rot):
        """Build args + dispatch reeval_scan_3d (async). Returns
        (node_ids, rv_handle, drop_handle) or None when no nodes."""
        lists = [self.index.cell_nodes(c) for c in kept]
        node_ids = (np.concatenate(lists) if lists
                    else np.zeros(0, np.int32))
        n = len(node_ids)
        if n == 0:
            return None
        k = _next_pow2(n)
        sel = np.full(k, -1, np.int32)
        sel[:n] = node_ids
        d = self.index.get_nodes(sel)
        valid = np.zeros(k, bool)
        valid[:n] = True
        centers, _, _ = self.index.cell_info(kept)
        coords = np.floor(centers / self.cell_size).astype(np.int32)
        cpad = _next_pow2(len(kept), lo=8)
        cc = np.zeros((cpad, 3), np.int32)
        cc[:len(kept)] = coords
        cok = np.zeros(cpad, bool)
        cok[:len(kept)] = True
        put = self._dev_batch((d["pos"], d["grad"], d["pos_sig"],
                               d["grad_sig"], valid, cc, cok, tr, rot))
        args = (obs, *put, jnp.float32(self.cell_size), self.p, self.op)
        if self.reeval_mode == "hybrid":
            rv, drop = mapper3d.reeval_hybrid_3d(
                *args, compat=self.compat_reloc)
        else:
            # static member bound per scan step: largest start-of-frame
            # cell plus 2x headroom for mid-frame boundary crossers.
            # Clamped to a 512 floor so the (k, kc) compile key stays
            # stable across frames — overflow is counted, never silent.
            kc = min(max(_next_pow2(2 * max(len(li) for li in lists)), 512),
                     _next_pow2(n))
            rv, drop = mapper3d.reeval_scan_3d(
                *args, compat=self.compat_reloc, kc=kc)
        return node_ids, rv, drop

    def _apply_reeval_fused(self, node_ids, rv, drop) -> None:
        """Host apply of fetched reeval_scan_3d results."""
        n = len(node_ids)
        if int(drop):
            self.stats["reeval_dropped"] = (
                self.stats.get("reeval_dropped", 0) + int(drop))
        self.index.apply_reeval(
            node_ids, np.asarray(rv.action)[:n], np.asarray(rv.pos)[:n],
            np.asarray(rv.grad)[:n], np.asarray(rv.noise)[:n],
            np.asarray(rv.grad_noise)[:n], np.asarray(rv.dbl_pos_sig)[:n],
            np.asarray(rv.dbl_grad_sig)[:n], -self.p.fbias)

    def _reeval_fused(self, obs, kept, tr, rot):
        """Strict per-cell re-evaluation in ONE device dispatch
        (mapper3d.reeval_scan_3d); host applies the final per-node actions
        once at frame end."""
        disp = self._dispatch_reeval_fused(obs, kept, tr, rot)
        if disp is None:
            return
        node_ids, rv, drop = disp
        # ONE host pull, ONE leaf (reuse the packed layout with an empty
        # new-measurement block)
        k_rv = rv.action.shape[0]
        empty_nm = mapper3d.NewMeas3D(
            insert_ok=jnp.zeros((1,), bool), pos=jnp.zeros((1, 3)),
            grad=jnp.zeros((1, 3)), noise=jnp.zeros((1,)),
            grad_noise=jnp.zeros((1,)))
        flat = jax.device_get(
            mapper3d.pack_frame_results(rv, drop, empty_nm))
        rv, drop, _ = mapper3d.unpack_frame_results(flat, k_rv, 1)
        self._apply_reeval_fused(node_ids, rv, drop)

    def _reeval_apply(self, obs, node_ids, tr, rot):
        if len(node_ids) == 0:
            return
        k = _next_pow2(len(node_ids))
        sel = np.full(k, -1, np.int32)
        sel[:len(node_ids)] = node_ids
        d = self.index.get_nodes(sel)
        valid = np.zeros(k, bool)
        valid[:len(node_ids)] = True

        rv = mapper3d.reeval_3d(
            obs, self._dev(d["pos"], shard=True),
            self._dev(d["grad"], shard=True),
            self._dev(d["pos_sig"], shard=True),
            self._dev(d["grad_sig"], shard=True),
            self._dev(valid, shard=True), self._dev(tr), self._dev(rot),
            self.p, self.op, compat=self.compat_reloc)

        rv = jax.device_get(rv)             # ONE host pull
        n = len(node_ids)
        self.index.apply_reeval(
            node_ids, np.asarray(rv.action)[:n], np.asarray(rv.pos)[:n],
            np.asarray(rv.grad)[:n], np.asarray(rv.noise)[:n],
            np.asarray(rv.grad_noise)[:n], np.asarray(rv.dbl_pos_sig)[:n],
            np.asarray(rv.dbl_grad_sig)[:n], -self.p.fbias)

    # ------------------------------------------------------------------
    def _update_gps(self):
        _retrain_store(self)

    # ------------------------------------------------------------------
    def _test_kwargs(self) -> dict:
        """The exact kwarg set test() passes to cluster.map_test — the
        single source for the 3D query constants (testSinglePoint,
        OnGPIS.cpp:208-213; var threshold 0.5, GPisMap3.cpp:800)."""
        return dict(
            cell_size=self.cell_size, grid_half=self.grid_half,
            noff=self._noff, search_half=self._search_half,
            scale=self.p.map_scale_param, val_const=1.001,
            grad_const=self.p.three_over_scale + 0.001,
            var_thre=self.p.test_var_thre,
            default_var=1.0 + self.p.map_noise_param,
            tile=self.cap.test_tile, max_cells=self.cap.max_cells,
            max_active=self.cap.test_active_cells)

    def test(self, x: np.ndarray) -> np.ndarray:
        """Batched SDF query (GPisMap3::test, GPisMap3.cpp:904-949).

        x: [N, 3]. Returns [N, 8] with testSinglePoint variance constants
        (OnGPIS.cpp:208-213) and var threshold 0.5 (GPisMap3.cpp:800).
        """
        x = np.asarray(x, np.float32).reshape(-1, 3)
        nq = x.shape[0]
        qp = _next_pow2(nq)
        # far-away padding: no candidate cells -> no evaluation tiles
        xq = np.full((qp, 3), 1e6, np.float32)
        xq[:nq] = x
        if self._nbrs is None:
            self._build_nbrs()
        f, g, vf, vg, info = self._map_test(xq)
        # ONE batched pull; the candidate-table overflow counter rides
        # along so table-path drops are never silent (CapacityParam.nbr_k)
        ovf = (self._nbrs.n_overflow if self._nbrs is not None
               else np.int32(0))
        f, g, vf, vg, info, ovf = jax.device_get((f, g, vf, vg, info, ovf))
        if int(ovf):
            self.stats["nbr_overflow"] = int(ovf)
        self.stats["test_eval_pairs"] = int(info.n_pairs)
        self.stats["test_phase2_queries"] = int(info.n_phase2)
        if int(info.n_dropped):
            self.stats["test_dropped_pairs"] = (
                self.stats.get("test_dropped_pairs", 0)
                + int(info.n_dropped))
        out = np.concatenate(
            [f[:, None], g, vf[:, None], vg], axis=-1)
        return out[:nq]

    def get_all_points(self) -> np.ndarray:
        """All live node positions (GPisMap3.cpp:951-972)."""
        d = self.index.dump_nodes()
        return d["pos"][d["alive"]]

    @property
    def num_nodes(self) -> int:
        return self.index.num_nodes
