"""User-facing online GPIS mappers.

GPisMap2D mirrors the full reference command surface
(update/test/reset, reference: cpp/include/GPisMap.h:103-105 and
mex/mexGPisMap.cpp) as a host orchestrator that drives:
  * the native spatial index (csrc/gpis_index.cpp) for tree mutations
  * jitted device stages (models/mapper2d.py) for all GP math
  * the device-resident cluster-GP store (models/cluster.py) for test()

GPisMap3D (models/mapper3d.py) adds setCamera/getAllPoints.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .config import (CAPACITY_2D, MAPPER_2D, OBSGP_1D, TREE_2D,
                     CapacityParam, MapperParam, ObsGPParam, TreeParam)
from .models import cluster, mapper2d
from .runtime import SpatialIndex


def _next_pow2(n: int, lo: int = 64) -> int:
    return max(lo, 1 << max(0, (n - 1)).bit_length())


class _MeshMixin:
    """Multi-device execution for the online mappers.

    The reference's parallel backend is a std::thread fan-out over query
    chunks and cluster cells (GPisMap.cpp:596-663,765-810 — C13). Here the
    same three hot loops run SPMD over a jax.sharding.Mesh instead:

      * test(): the query batch is sharded along the mesh axis, the
        cluster-GP store / grid / factor cache replicated — pure data
        parallel, zero cross-chip traffic in the forward loop.
      * update() re-evaluation: the in-view node batch and the beam batch
        are sharded; the (tiny) observation GP is computed replicated.
      * retrain: the per-cell GP fit batch is sharded; the updated store
        is re-replicated afterwards (the SURVEY §5.8 all-gather of the
        node table after each update step, inserted by XLA).

    All device entry points route through _dev(); capacity paddings are
    powers of two >= 64, so any power-of-two mesh up to 64 devices
    divides every sharded axis.
    """

    # Retrain fit dispatch: True fits every touched cell in ONE dispatch
    # at the smallest support bucket covering the largest cell; False
    # groups cells by support-size bucket, one dispatch per bucket
    # (fewer FLOPs, more dispatches). Chosen on the H100 (CHANGES.md).
    one_fit_dispatch = True

    @property
    def wall_stats(self):
        """Host-side wall-clock accumulators (seconds) for the pipelined
        update loop: uploads, dispatch enqueueing, the one blocking pull
        per frame and the host tree replay."""
        if not hasattr(self, "_wall_stats"):
            import collections
            self._wall_stats = collections.defaultdict(float)
        return self._wall_stats

    def _init_mesh(self, mesh):
        self.mesh = mesh
        if mesh is None:
            self._sh_data = self._sh_rep = None
            return
        from jax.sharding import NamedSharding, PartitionSpec as P
        if 64 % mesh.size != 0 or self.cap.retrain_batch % mesh.size != 0:
            raise ValueError(
                f"mesh size {mesh.size} must be a power of two dividing "
                f"64 and retrain_batch={self.cap.retrain_batch} "
                "(sharded axes are padded to multiples of these)")
        axis = mesh.axis_names[0]
        self._sh_data = NamedSharding(mesh, P(axis))
        self._sh_rep = NamedSharding(mesh, P())

    def _dev(self, x, shard: bool = False):
        """Host -> device with the mapper's sharding (axis 0 if shard).
        Accepts arrays or pytrees (e.g. the ClusterStore)."""
        if self.mesh is None:
            return jax.device_put(x)
        return jax.device_put(x, self._sh_data if shard else self._sh_rep)

    def _dev_batch(self, arrays, shard_flags=None):
        """ONE batched host->device transfer for several arrays."""
        if self.mesh is None:
            return jax.device_put(tuple(arrays))
        if shard_flags is None:
            shard_flags = (False,) * len(arrays)
        shs = tuple(self._sh_data if f else self._sh_rep
                    for f in shard_flags)
        return jax.device_put(tuple(arrays), shs)

    def _replicate_state(self):
        """Pin store (+ factors) to the replicated sharding after retrain
        so per-frame compiles see stable input shardings."""
        if self.mesh is not None:
            self.store = jax.device_put(self.store, self._sh_rep)

    # -- newmeas apply (shared by both mappers) ------------------------
    def _apply_newmeas(self, nm) -> int:
        """Step 3 host apply: dedup + insert new hits (GPisMap.cpp:492-568).
        Returns the number of inserted nodes."""
        ok = np.asarray(nm.insert_ok)
        if not ok.any():
            return 0
        cand = np.asarray(nm.pos)[ok]
        ids = self.index.try_insert(cand)
        ins = ids >= 0
        if ins.any():
            self.index.set_node_data(
                ids[ins], np.full(ins.sum(), -self.p.fbias, np.float32),
                np.asarray(nm.noise)[ok][ins],
                np.asarray(nm.grad)[ok][ins],
                np.asarray(nm.grad_noise)[ok][ins])
        return int(ins.sum())

    # -- factor cache (shared by both mappers) -------------------------
    def _live_slots(self) -> np.ndarray:
        """Sorted live cluster slots (the current factor-cache key)."""
        cells = self.index.all_cluster_cells(cap=self.cap.max_cells * 4)
        if len(cells) == 0:
            return np.zeros(0, np.int32)
        _, _, slots = self.index.cell_info(cells)
        return np.sort(slots[slots >= 0]).astype(np.int32)

    def _get_factors(self):
        """Bounded cache of per-cell Cholesky factors (the reference keeps
        L per cell, OnGPIS.h; recomputed only after retraining). Falls back
        to per-call factorization when the live-cell count exceeds the
        cache bound."""
        if self._factors is not None:
            return self._factors
        live = self._live_slots()
        if len(live) == 0 or len(live) > self.cap.test_active_cells:
            return None
        pad = np.full(self.cap.test_active_cells, -1, np.int32)
        pad[:len(live)] = live
        self._factors = cluster.factorize_slots(
            self.store, self._dev(pad), self.p.map_scale_param,
            self.cap.test_active_cells)
        self._factors_slots = live
        if self.mesh is not None:
            self._factors = jax.device_put(self._factors, self._sh_rep)
        return self._factors

    # -- device node mirror (shared by both mappers) -------------------
    def _use_mirror(self) -> bool:
        """Device-resident node-table mirror (SURVEY §7): retrain support
        travels as indices, not gathered arrays. Identical values by
        construction; GPISMAP_NODE_MIRROR=0 disables."""
        import os as _os
        return _os.environ.get("GPISMAP_NODE_MIRROR", "1") not in (
            "0", "off")

    def _sync_mirror(self) -> None:
        """Scatter this frame's mutated nodes into the device mirror
        (SpatialIndex tracks them; a fresh/loaded map seeds everything)."""
        if not self._use_mirror():
            self._mirror = None
            return
        if self._mirror is None:
            self._mirror = self._dev(cluster.make_mirror(self.cap,
                                                         self.dim))
            d = self.index.dump_nodes()
            ids = np.nonzero(d["alive"])[0].astype(np.int32)
            self.index.pop_dirty()      # the full seed covers everything
        else:
            ids = self.index.pop_dirty()
        if len(ids) == 0:
            return
        k = _next_pow2(len(ids))
        sel = np.full(k, -1, np.int32)
        sel[:len(ids)] = ids
        nd = self.index.get_nodes(sel)
        args = self._dev_batch((sel, nd["pos"], nd["grad"], nd["val"],
                                nd["pos_sig"], nd["grad_sig"]))
        self._mirror = cluster.scatter_mirror(self._mirror, *args)
        if self.mesh is not None:
            self._mirror = jax.device_put(self._mirror, self._sh_rep)

    # -- dense cluster grid (shared by both mappers) -------------------
    def _grid_host_arrays(self):
        """Padded (coords, slots) live-cell arrays for the device grid
        build."""
        cells = self.index.all_cluster_cells(cap=self.cap.max_cells * 4)
        n = 0
        if len(cells):
            centers, _, slots = self.index.cell_info(cells)
            live = slots >= 0
            n = int(live.sum())
        cpad = _next_pow2(max(n, 1))
        cc = np.zeros((cpad, self.dim), np.int32)
        sl = np.full(cpad, -1, np.int32)
        if n:
            cc[:n] = np.floor(centers[live] / self.cell_size).astype(
                np.int32)
            sl[:n] = slots[live]
        return cc, sl

    def _rebuild_grid(self) -> None:
        """Dense cluster grid rebuilt ON DEVICE from the live-cell list
        (cluster.build_grid_device): only the [C, D] cell list travels
        per frame instead of the 262 KB (2D) / 8 MB (3D) dense map."""
        cc, sl = self._grid_host_arrays()
        ccd, sld = self._dev_batch((cc, sl))
        self.grid = cluster.build_grid_device(ccd, sld, self.dim,
                                              self.grid_half)
        if self.mesh is not None:
            self.grid = jax.device_put(self.grid, self._sh_rep)

    # -- candidate table (shared by both mappers) ----------------------
    def _use_nbr_table(self) -> bool:
        """Precomputed candidate rows for test() (cluster.NeighborTable):
        row gathers instead of per-query window gathers; exactly
        equivalent results. Off by default: on the H100 the window gather
        is as fast and needs no table rebuild per retrain (CHANGES.md);
        GPISMAP_NBR_TABLE=1 turns the table on."""
        import os as _os
        return _os.environ.get("GPISMAP_NBR_TABLE", "0") in ("1", "on")

    def _build_nbrs(self) -> None:
        """(Re)build the candidate table after a retrain — async
        dispatch off the test path (`trained` is baked in, so any
        retrain/prune/insert invalidates it)."""
        if not self._use_nbr_table():
            self._nbrs = None
            return
        cells = self.index.all_cluster_cells(cap=self.cap.max_cells * 4)
        if len(cells) == 0:
            self._nbrs = None
            return
        centers, _, slots = self.index.cell_info(cells)
        live = slots >= 0
        n = int(live.sum())
        if n == 0:
            self._nbrs = None
            return
        coords = np.floor(centers / self.cell_size).astype(np.int32)
        cpad = _next_pow2(n)
        cc = np.zeros((cpad, self.dim), np.int32)
        sl = np.full(cpad, -1, np.int32)
        cc[:n] = coords[live]
        sl[:n] = slots[live]
        side = 2 * self.grid_half
        self._nbr_dense = side ** self.dim <= (1 << 18)
        ccd, sld = self._dev_batch((cc, sl))
        self._nbrs = cluster.build_neighbor_table(
            ccd, sld, self.store.trained,
            self.grid_half, self._noff, self.cap.nbr_k, self._nbr_dense)
        if self.mesh is not None:
            self._nbrs = jax.device_put(self._nbrs, self._sh_rep)

    # -- query dispatch (shared by both mappers) -----------------------
    def _map_test(self, xq: np.ndarray):
        """Enqueue the query program on a padded batch (shared by both
        mappers)."""
        fn = cluster.map_test if self.mesh is None \
            else cluster.map_test_sharded
        return fn(
            self.store, self.grid, self._dev(xq, shard=True),
            factors=self._get_factors(), nbrs=self._nbrs, nbr_dense=self._nbr_dense,
            **self._test_kwargs(),
            **({} if self.mesh is None else {"mesh": self.mesh}))

    def _refresh_buckets(self) -> tuple:
        """Static refresh-size set: at most TWO groups — the largest
        sub-capacity bucket (cluster.refresh_bucket), then full capacity.
        Two, not one-per-retrain-bucket: each chained update_factors
        dispatch holds a full [S, M', M'] buffer copy alive until the
        chain completes (3D: 2.1 GB each), and the mid bucket already
        captures most of the FLOP saving ((160/320)^3 = 1/8).
        """
        subs = [cluster.refresh_bucket(b, self.cap.gp_support, self.dim)
                for b in self._retrain_buckets]
        subs = sorted({s for s in subs if s is not None})
        return ((subs[-1],) if subs else ()) + (None,)

    def _refresh_factors(self, retrained_slots: np.ndarray,
                         counts: np.ndarray | None = None,
                         fit_ls=None) -> None:
        """Incremental factor-cache maintenance after a retrain.

        If the live slot set is unchanged since the cache was filled, only
        the just-retrained cells' factors refresh — so the next test()
        skips the full factorize_slots refill. Any slot-set change
        (insert into a new cell, prune) falls back to full invalidation.

        fit_ls: list of (padded slot rows, fit Cholesky factor handle)
        from the retrain — the refresh then only inverts the factor the
        fit already computed (cluster.update_factors_from_l, the
        reference's keep-L architecture; ~3.5x cheaper than the rebuild).
        Without it, cells re-factorize grouped by refresh bucket
        (counts; cluster.update_factors)."""
        old, self._factors = self._factors, None
        if old is None or getattr(self, "_factors_slots", None) is None:
            self._factors_slots = None
            return
        live = self._live_slots()
        if (len(live) == 0 or len(live) > self.cap.test_active_cells
                or not np.array_equal(live, self._factors_slots)):
            self._factors_slots = None
            return
        if len(retrained_slots) == 0:      # nothing retrained: still valid
            self._factors = old
            return
        linv_buf, uniq = old
        if fit_ls:
            for sl_np, l in fit_ls:
                linv_buf = cluster.update_factors_from_l(
                    linv_buf, uniq, self._dev(np.asarray(sl_np)), l,
                    d=self.dim)
        else:
            buckets = self._refresh_buckets()
            if counts is None:
                groups = [(None, np.asarray(retrained_slots))]
            else:
                groups = []
                assigned = np.zeros(len(retrained_slots), bool)
                for mb2 in buckets:
                    sel = (~assigned if mb2 is None
                           else (~assigned) & (counts <= mb2))
                    assigned |= sel
                    if sel.any():
                        groups.append(
                            (mb2, np.asarray(retrained_slots)[sel]))
            for mb2, sl_np in groups:
                bpad = _next_pow2(len(sl_np), lo=8)
                sl = np.full(bpad, -1, np.int32)
                sl[:len(sl_np)] = sl_np
                linv_buf = cluster.update_factors(
                    self.store, linv_buf, uniq, self._dev(sl),
                    self.p.map_scale_param, mb=mb2)
        self._factors = (linv_buf, uniq)
        if self.mesh is not None:
            self._factors = jax.device_put(self._factors, self._sh_rep)


def _retrain_store(m) -> None:
    """Step 4 shared by both mappers: retrain touched cluster GPs
    (GPisMap.cpp:596-663 / GPisMap3.cpp:720-792) with support-count size
    buckets.

    Cells are grouped by support count into pow2-ish size buckets and each
    bucket is fitted at its own (static) padding — the load-balancing-by-
    size-bucket scheme from SURVEY §7: a batch of mostly-small cells costs
    (mb/M)^3 of the full-padding Cholesky FLOPs instead of all cells
    paying the worst case. Results are exactly equal to full-padding fits
    (masked identity rows; see cluster.retrain_cells).
    """
    import time as _time
    wall = m.wall_stats
    _t = _time.time()
    mcap = m.cap.gp_support
    rt = m.index.collect_retrain(m.p.gp_radius_times, mcap,
                                 m.cap.retrain_batch * 16)
    wall["retrain.collect_host"] += _time.time() - _t
    b = rt["n"]
    groups = []
    chunk_cap = m.cap.retrain_batch
    if b:
        if rt["total"] > b:
            m.stats["retrain_truncated"] = rt["total"] - b
        counts = rt["counts"][:b]
        # batch rows are padded to a pow2 >= the mesh size: a bucket with 5
        # touched cells fits at B=8, not the worst-case retrain_batch
        if m.one_fit_dispatch:
            # ONE dispatch at the smallest bucket covering the largest cell
            mb1 = next((bb for bb in m._retrain_buckets
                        if bb >= counts.max()), m._retrain_buckets[-1])
            groups = [(mb1, np.arange(b))]
        else:
            assigned = np.zeros(b, bool)
            for mb in m._retrain_buckets:
                if mb >= mcap:
                    selb = ~assigned
                else:
                    selb = (~assigned) & (counts <= mb)
                assigned |= selb
                rows = np.nonzero(selb)[0]
                if len(rows):
                    groups.append((mb, rows))

    # One-dispatch epilogue (mirror scatter + retrain + grid rebuild
    # fused, cluster.frame_finish_full) whenever the frame fits one
    # retrain chunk: one program and one upload instead of several.
    fused = (b > 0 and m.mesh is None and m._use_mirror()
             and m._mirror is not None and len(groups) == 1
             and len(groups[0][1]) <= chunk_cap)
    fit_ls = []          # (padded slot rows, fit Cholesky factor) pairs
    factors_folded = False
    _t = _time.time()
    if fused:
        mb, rows = groups[0]
        chunk = min(chunk_cap, _next_pow2(len(rows), lo=8))
        sup = np.full((chunk, mb), -1, np.int32)
        sup[:b] = rt["support"][:b, :mb]
        slots = np.full(chunk, -1, np.int32)
        slots[:b] = rt["slots"][:b]
        ids = m.index.pop_dirty()
        k = _next_pow2(max(len(ids), 1))
        sel = np.full(k, -1, np.int32)
        sel[:len(ids)] = ids
        nd = m.index.get_nodes(sel)
        cc, sl = m._grid_host_arrays()
        # fold the two test-path upkeep dispatches into the SAME program:
        # the factor refresh whenever the cache
        # is valid and the live slot set unchanged (the exact host gate
        # _refresh_factors applies), and the candidate-table rebuild
        # whenever the table path is on
        live = m._live_slots()
        with_factors = (
            m._factors is not None
            and getattr(m, "_factors_slots", None) is not None
            and 0 < len(live) <= m.cap.test_active_cells
            and np.array_equal(live, m._factors_slots))
        with_nbrs = m._use_nbr_table() and len(live) > 0
        if with_nbrs:
            side = 2 * m.grid_half
            m._nbr_dense = side ** m.dim <= (1 << 18)
        if with_factors:
            linv_buf, uniq = m._factors
            m._factors = None         # buffer is donated below
        else:
            linv_buf = jnp.zeros((1, 1, 1), jnp.float32)
            uniq = jnp.zeros((1,), jnp.int32)
        wall["retrain.collect_host"] += _time.time() - _t
        _t = _time.time()
        args = m._dev_batch((sel, nd["pos"], nd["grad"], nd["val"],
                             nd["pos_sig"], nd["grad_sig"],
                             slots, slots >= 0, sup, cc, sl))
        m.store, m._mirror, m.grid, fit_l, nbrs, new_linv = \
            cluster.frame_finish_full(
                m.store, m._mirror, *args[:9], m.p.map_scale_param,
                *args[9:], linv_buf, uniq,
                m.dim, m.grid_half, m._noff, m.cap.nbr_k,
                getattr(m, "_nbr_dense", False), with_factors, with_nbrs)
        if with_factors:
            m._factors = (new_linv, uniq)
            factors_folded = True
        if with_nbrs:
            m._nbrs = nbrs
        else:
            m._nbrs = None
        fit_ls.append((slots, fit_l))
        m.index.clear_active()
        wall["retrain.fit_dispatch"] += _time.time() - _t
    else:
        m._sync_mirror()     # flush this frame's node mutations to device
        wall["retrain.mirror_sync"] += _time.time() - _t
        _t = _time.time()
        lo = 8 if m.mesh is None else max(8, m.mesh.size)
        for mb, rows in groups:
            chunk = min(chunk_cap, _next_pow2(len(rows), lo=lo))
            for s in range(0, len(rows), chunk):
                rr = rows[s:s + chunk]
                bb = len(rr)
                sup = np.full((chunk, mb), -1, np.int32)
                sup[:bb] = rt["support"][rr][:, :mb]
                slots = np.full(chunk, -1, np.int32)
                slots[:bb] = rt["slots"][rr]
                if m._mirror is not None:
                    # support gathered on device from the node mirror:
                    # only the index array travels (one batched put)
                    sl_d, ok_d, sup_d = m._dev_batch(
                        (slots, slots >= 0, sup),
                        (False, False, True))
                    if m.mesh is None:
                        m.store, fit_l = \
                            cluster.retrain_cells_from_mirror_with_l(
                                m.store, m._mirror, sl_d, ok_d, sup_d,
                                m.p.map_scale_param)
                        fit_ls.append((slots, fit_l))
                    else:
                        m.store = cluster.retrain_cells_from_mirror(
                            m.store, m._mirror, sl_d, ok_d, sup_d,
                            m.p.map_scale_param)
                    continue
                vmask = sup >= 0
                nd = m.index.get_nodes(sup.reshape(-1))
                shp = sup.shape
                m.store = cluster.retrain_cells(
                    m.store, m._dev(slots), m._dev(slots >= 0),
                    m._dev(nd["pos"].reshape(shp + (m.dim,)), shard=True),
                    m._dev(nd["grad"].reshape(shp + (m.dim,)), shard=True),
                    m._dev(nd["val"].reshape(shp), shard=True),
                    m._dev(nd["pos_sig"].reshape(shp), shard=True),
                    m._dev(nd["grad_sig"].reshape(shp), shard=True),
                    m._dev(vmask, shard=True), m.p.map_scale_param)
        wall["retrain.fit_dispatch"] += _time.time() - _t
        _t = _time.time()
        m.index.clear_active()
        m._rebuild_grid()
        wall["retrain.grid_rebuild"] += _time.time() - _t
    _t = _time.time()
    if not fused:
        m._nbrs = None   # candidate table rebuilt lazily at next test()
    if factors_folded:
        # refresh already happened inside frame_finish_full; the slot
        # set was verified unchanged, so _factors_slots stays valid
        pass
    else:
        m._refresh_factors(rt["slots"][:b] if b else np.zeros(0, np.int32),
                           counts=rt["counts"][:b] if b else None,
                           fit_ls=fit_ls or None)
    m._replicate_state()
    wall["retrain.factor_refresh"] += _time.time() - _t


def _default_buckets(mcap: int) -> tuple:
    """Support-size buckets (ascending, last == capacity): quarter, half
    and full capacity."""
    cand = sorted({max(16, mcap // 4), max(16, mcap // 2), mcap})
    return tuple(b for b in cand if b <= mcap)


class GPisMap2D(_MeshMixin):
    """Online continuous 2D SDF mapper from LiDAR scans.

    update(thetas, ranges, pose6) ingests one scan with pose
    [tx, ty, R00, R10, R01, R11] (column-major 2x2, matching the mex
    convention, mexGPisMap.cpp:57-67 / demo_gpisMap.m:49-51);
    test(x) returns [N, 6] = [f, gx, gy, var_f, var_gx, var_gy]
    (mexGPisMap.cpp:99).

    Pass `mesh` (jax.sharding.Mesh, one axis) to run the full online
    loop SPMD over multiple devices (see _MeshMixin).
    """

    def __init__(self, params: MapperParam = MAPPER_2D,
                 obs_param: ObsGPParam = OBSGP_1D,
                 tree: TreeParam = TREE_2D,
                 cap: CapacityParam = CAPACITY_2D,
                 strict_reeval: bool = False,
                 mesh=None):
        self.p = params
        self.op = obs_param
        self.tp = tree
        self.cap = cap
        self.dim = 2
        # strict_reeval replays the reference's per-cluster processing
        # order during re-evaluation (each cell's nodes gathered AFTER
        # earlier cells' mutations, so nodes moved forward get
        # re-evaluated, GPisMap.cpp:192-229). The batched default
        # evaluates a single snapshot — measurably identical on the 2D
        # data (99.98% field agreement) and one device call per frame.
        self.strict_reeval = strict_reeval
        self._init_mesh(mesh)
        self.index = SpatialIndex(self.dim, tree, max_slots=cap.max_cells)
        self.store = self._dev(cluster.make_store(cap, self.dim))
        self.cell_size = 2.0 * tree.cluster_halfleng
        # final root can double once past max_halfleng
        # (quadtree.cpp:162-165): extent = 2 * max_halfleng
        self.grid_half = int(round(2.0 * tree.max_halfleng / self.cell_size))
        self.grid = self._dev(cluster.build_grid(
            np.zeros((0, self.dim), np.int64), np.zeros(0, np.int32),
            self.dim, self.grid_half))
        self._search_half = params.map_scale_param * 4.0  # GPisMap.cpp:680
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
    def reset(self):
        """Drop all map state (mexGPisMap.cpp:123-130)."""
        self.index.reset()
        self.store = self._dev(cluster.make_store(self.cap, self.dim))
        self.grid = self._dev(cluster.build_grid(
            np.zeros((0, self.dim), np.int64), np.zeros(0, np.int32),
            self.dim, self.grid_half))
        self.frame = 0
        self._factors = None
        self._factors_slots = None
        self._nbrs = None
        self._mirror = None

    # ------------------------------------------------------------------
    def update(self, thetas: np.ndarray, ranges: np.ndarray,
               pose: np.ndarray) -> None:
        """Ingest one scan (reference: GPisMap::update, GPisMap.cpp:151-167).

        Per-frame counters and stage timings land in self.stats (the
        reference only exposes whole-call wall clock, mexGPisMap.cpp:69-79).
        """
        import time as _time
        _t0 = _time.time()
        thetas = np.asarray(thetas, np.float32).reshape(-1)
        ranges = np.asarray(ranges, np.float32).reshape(-1)
        pose = np.asarray(pose, np.float32).reshape(-1)
        tr = pose[:2]
        rot = pose[2:6].reshape(2, 2, order="F")

        nb = _next_pow2(len(thetas))
        th_p = np.full(nb, 0.0, np.float32)
        rg_p = np.zeros(nb, np.float32)
        th_p[:len(thetas)] = thetas
        rg_p[:len(ranges)] = ranges
        # padded beams carry invalid range 0 -> range-gated out

        # host-side range gate (identical to preprocess_2d's, so the
        # in-view cull can run BEFORE the single fused device dispatch)
        validh = (rg_p > self.p.min_range) & (rg_p < self.p.max_range)
        n_valid = int(validh.sum())
        if n_valid <= 1:           # preproData failure (GPisMap.cpp:145-148)
            return
        rmax = float(rg_p[validh].max())
        g_max = nb // self.op.group_size + 2

        if self.strict_reeval:
            prep, obs, nm = mapper2d.frame_compute_2d(
                self._dev(th_p, shard=True), self._dev(rg_p, shard=True),
                self._dev(tr), self._dev(rot), self.p, self.op, g_max=g_max)
            self._update_map_points(obs, tr, rot, rmax)
        else:
            # whole frame in ONE device dispatch (+ retrain below)
            node_ids = self._inview_node_ids(tr, rot, rmax)
            k = _next_pow2(max(len(node_ids), 1))
            sel = np.full(k, -1, np.int32)
            sel[:len(node_ids)] = node_ids
            d = self.index.get_nodes(sel)
            nvalid = np.zeros(k, bool)
            nvalid[:len(node_ids)] = True
            rv, nm = mapper2d.frame_update_2d(
                self._dev(th_p, shard=True), self._dev(rg_p, shard=True),
                self._dev(tr), self._dev(rot),
                self._dev(d["pos"], shard=True),
                self._dev(d["grad"], shard=True),
                self._dev(d["pos_sig"], shard=True),
                self._dev(d["grad_sig"], shard=True),
                self._dev(nvalid, shard=True), self.p,
                self.op, g_max=g_max)
            # ONE host pull, ONE leaf (see pack_frame_results)
            kk = rv.action.shape[0]
            nb_nm = nm.insert_ok.shape[0]
            rv, nm = mapper2d.unpack_frame_results(
                jax.device_get(mapper2d.pack_frame_results(rv, nm)),
                kk, nb_nm)
            n = len(node_ids)
            if n:
                self.index.apply_reeval(
                    node_ids, np.asarray(rv.action)[:n],
                    np.asarray(rv.pos)[:n], np.asarray(rv.grad)[:n],
                    np.asarray(rv.noise)[:n], np.asarray(rv.grad_noise)[:n],
                    np.asarray(rv.dbl_pos_sig)[:n],
                    np.asarray(rv.dbl_grad_sig)[:n], -self.p.fbias)

        # Step 3 apply: insert new measurements
        nm = jax.device_get(nm)
        n_new = self._apply_newmeas(nm)

        # Step 4: retrain touched cluster GPs (GPisMap.cpp:596-663)
        _t1 = _time.time()
        self._update_gps()
        self.stats.update(
            frame=self.frame, n_valid_beams=n_valid,
            n_nodes=self.index.num_nodes,
            n_cluster_cells=int(self.index.max_slot),
            new_inserted=n_new,
            support_overflow=int(self.index.overflow_count),
            update_s=round(_time.time() - _t0, 4),
            retrain_s=round(_time.time() - _t1, 4))
        self.frame += 1

    def update_batch(self, frames) -> None:
        """Pipelined multi-frame ingestion — semantically the per-frame
        update() loop (snapshot re-evaluation), restructured so the
        device never waits on the host: the tree-independent device
        program of EVERY frame (preprocess + obs fit + new-measurement
        evaluation, mapper2d.frame_compute_2d) is dispatched up front, so
        its device time and argument upload overlap the one blocking
        pull per frame (re-evaluation pull -> host tree replay) instead
        of serializing with it.

        frames: iterable of (thetas, ranges, pose6) — the reference demo
        loop's per-frame arguments (demo_gpisMap.m:42-51).
        """
        import time as _time
        if self.strict_reeval:
            for th, rg, pose in frames:
                self.update(th, rg, pose)
            return
        pend = []
        _tp0 = _time.time()
        for th, rg, pose in frames:
            th = np.asarray(th, np.float32).reshape(-1)
            rg = np.asarray(rg, np.float32).reshape(-1)
            pose = np.asarray(pose, np.float32).reshape(-1)
            tr = pose[:2]
            rot = pose[2:6].reshape(2, 2, order="F")
            nb = _next_pow2(len(th))
            th_p = np.zeros(nb, np.float32)
            rg_p = np.zeros(nb, np.float32)
            th_p[:len(th)] = th
            rg_p[:len(rg)] = rg
            validh = (rg_p > self.p.min_range) & (rg_p < self.p.max_range)
            n_valid = int(validh.sum())
            if n_valid <= 1:
                pend.append(None)
                continue
            rmax = float(rg_p[validh].max())
            g_max = nb // self.op.group_size + 2
            th_d, rg_d, tr_d, rot_d = self._dev_batch(
                (th_p, rg_p, tr, rot), (True, True, False, False))
            _, obs, nm = mapper2d.frame_compute_2d(
                th_d, rg_d, tr_d, rot_d, self.p, self.op, g_max=g_max)
            pend.append((tr, rot, rmax, n_valid, obs, nm))
        self.wall_stats["precompute_dispatch"] += _time.time() - _tp0

        wall = self.wall_stats
        for item in pend:
            if item is None:
                continue
            _t0 = _time.time()
            tr, rot, rmax, n_valid, obs, nm = item
            node_ids = self._inview_node_ids(tr, rot, rmax)
            n = len(node_ids)
            k = 0
            _t = _time.time()
            wall["inview_host"] += _t - _t0
            if n:
                k = _next_pow2(n)
                sel = np.full(k, -1, np.int32)
                sel[:n] = node_ids
                d = self.index.get_nodes(sel)
                valid = np.zeros(k, bool)
                valid[:n] = True
                _t2 = _time.time()
                wall["gather_host"] += _t2 - _t
                args = self._dev_batch(
                    (d["pos"], d["grad"], d["pos_sig"], d["grad_sig"],
                     valid, tr, rot),
                    (True, True, True, True, True, False, False))
                _t = _time.time()
                wall["upload"] += _t - _t2
                rv = mapper2d.reeval_2d(obs, *args, self.p, self.op)
                flat = mapper2d.pack_frame_results(rv, nm)
                _t2 = _time.time()
                wall["reeval_dispatch"] += _t2 - _t
                _t = _t2
            else:
                flat = mapper2d.pack_nm_only(nm)
            # ONE blocking pull/frame, ONE pytree leaf
            nb = nm.insert_ok.shape[0]
            rv, nm = mapper2d.unpack_frame_results(
                jax.device_get(flat), k, nb)
            _t2 = _time.time()
            wall["blocking_pull"] += _t2 - _t
            if n:
                self.index.apply_reeval(
                    node_ids, np.asarray(rv.action)[:n],
                    np.asarray(rv.pos)[:n], np.asarray(rv.grad)[:n],
                    np.asarray(rv.noise)[:n],
                    np.asarray(rv.grad_noise)[:n],
                    np.asarray(rv.dbl_pos_sig)[:n],
                    np.asarray(rv.dbl_grad_sig)[:n], -self.p.fbias)
            _t = _time.time()
            wall["tree_replay"] += _t - _t2
            n_new = self._apply_newmeas(nm)
            _t1 = _time.time()
            wall["newmeas_apply"] += _t1 - _t
            self._update_gps()
            wall["retrain_total"] += _time.time() - _t1
            wall["n_frames"] += 1
            self.stats.update(
                frame=self.frame, n_valid_beams=n_valid,
                n_nodes=self.index.num_nodes,
                n_cluster_cells=int(self.index.max_slot),
                new_inserted=n_new,
                support_overflow=int(self.index.overflow_count),
                update_s=round(_time.time() - _t0, 4),
                retrain_s=round(_time.time() - _t1, 4))
            self.frame += 1

    # ------------------------------------------------------------------
    def _inview_cells(self, tr, rot, rmax):
        """Cluster cells passing the range + FOV culls
        (GPisMap.cpp:184-222), in reference traversal order."""
        if self.index.num_nodes == 0:
            return np.zeros(0, np.int32)
        cells, _ = self.index.query_cluster_cells(tr, rmax, cap=65536)
        if len(cells) == 0:
            return cells
        centers, halfs, _ = self.index.cell_info(cells)
        # range cull (GPisMap.cpp:196-199)
        sqr = np.sum((centers - tr) ** 2, -1)
        keep = sqr <= rmax * rmax + 2.0 * halfs * halfs
        # FOV cull by cell corners (GPisMap.cpp:202-222)
        corners = centers[:, None, :] + halfs[:, None, None] * np.array(
            [[-1, 1], [1, 1], [-1, -1], [1, -1]], np.float32)
        loc = (corners - tr) @ rot
        loc = loc - np.asarray(self.p.sensor_offset, np.float32)
        ang = np.arctan2(loc[..., 1], loc[..., 0])
        lim = self.p.angle_obs_limit
        within = np.any((ang > lim[0]) & (ang < lim[1]), axis=-1)
        keep &= within
        return cells[keep]

    def _inview_node_ids(self, tr, rot, rmax):
        cells = self._inview_cells(tr, rot, rmax)
        if len(cells) == 0:
            return np.zeros(0, np.int32)
        ids = [self.index.cell_nodes(c) for c in cells]
        return np.concatenate(ids) if ids else np.zeros(0, np.int32)

    def _update_map_points(self, obs, tr, rot, rmax):
        # strict mode: reference order — gather each cell's nodes at
        # processing time (after earlier cells' mutations),
        # GPisMap.cpp:192-229
        for c in self._inview_cells(tr, rot, rmax):
            self._reeval_apply(obs, self.index.cell_nodes(c), tr, rot)

    def _reeval_apply(self, obs, node_ids, tr, rot):
        if len(node_ids) == 0:
            return
        k = _next_pow2(len(node_ids))
        sel = np.full(k, -1, np.int32)
        sel[:len(node_ids)] = node_ids
        d = self.index.get_nodes(sel)
        valid = np.zeros(k, bool)
        valid[:len(node_ids)] = True

        rv = mapper2d.reeval_2d(
            obs, self._dev(d["pos"], shard=True),
            self._dev(d["grad"], shard=True),
            self._dev(d["pos_sig"], shard=True),
            self._dev(d["grad_sig"], shard=True),
            self._dev(valid, shard=True), self._dev(tr), self._dev(rot),
            self.p, self.op)

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
        single source for the 2D query constants (GPisMap.cpp:671,685;
        OnGPIS.cpp:170-172); tools and the multi-process drivers reuse it
        so profiled/sharded programs can't drift from production."""
        return dict(
            cell_size=self.cell_size, grid_half=self.grid_half,
            noff=self._noff, search_half=self._search_half,
            scale=self.p.map_scale_param, val_const=1.01,
            grad_const=self.p.three_over_scale + 0.1,
            var_thre=self.p.test_var_thre,
            default_var=1.0 + self.p.map_noise_param,
            tile=self.cap.test_tile, max_cells=self.cap.max_cells,
            max_active=self.cap.test_active_cells)

    def _test_dispatch(self, x: np.ndarray):
        """Dispatch-only half of test(): pad, (re)build caches, enqueue
        the query program. Returns ((f, g, vf, vg, info) device handles,
        nq). Lets callers pipeline several query batches before pulling
        any results (bench.py streamed throughput)."""
        x = np.asarray(x, np.float32).reshape(-1, self.dim)
        nq = x.shape[0]
        qp = _next_pow2(nq)
        # pad with a far-away point: padded queries get zero candidate
        # cells, so they open no evaluation tiles (origin-padding would
        # evaluate real cluster GPs just to discard the rows)
        xq = np.full((qp, self.dim), 1e6, np.float32)
        xq[:nq] = x
        if self._nbrs is None:
            self._build_nbrs()
        return self._map_test(xq), nq

    def test(self, x: np.ndarray) -> np.ndarray:
        """Batched SDF query (reference: GPisMap::test, GPisMap.cpp:765-810).

        x: [N, 2] world points. Returns [N, 6]:
        [f, gx, gy, var_f, var_gx, var_gy] with the unmapped sentinel
        var_f = 1 + map_noise (GPisMap.cpp:685).

        With a mesh, the query batch is sharded over the devices (the
        SPMD equivalent of the reference's test_kernel thread chunking,
        GPisMap.cpp:765-810).
        """
        (f, g, vf, vg, info), nq = self._test_dispatch(x)
        # ONE batched host pull; the candidate-table overflow counter
        # rides along so table-path drops are never silent (config.py
        # CapacityParam.nbr_k)
        ovf = (self._nbrs.n_overflow if self._nbrs is not None
               else np.int32(0))
        f, g, vf, vg, info, ovf = jax.device_get((f, g, vf, vg, info, ovf))
        if int(ovf):
            self.stats["nbr_overflow"] = int(ovf)
        self.stats["test_eval_pairs"] = int(info.n_pairs)
        self.stats["test_phase2_queries"] = int(info.n_phase2)
        if int(info.n_dropped):
            # max_active overflow / factor-cache miss dropped evaluations
            self.stats["test_dropped_pairs"] = (
                self.stats.get("test_dropped_pairs", 0)
                + int(info.n_dropped))
        out = np.concatenate(
            [f[:, None], g, vf[:, None], vg], axis=-1)
        return out[:nq]

    # ------------------------------------------------------------------
    def get_all_points(self) -> np.ndarray:
        """All live surface-node positions (parity with GPisMap3's
        getAllPoints, GPisMap3.cpp:951-972; provided for 2D too)."""
        d = self.index.dump_nodes()
        return d["pos"][d["alive"]]

    @property
    def num_nodes(self) -> int:
        return self.index.num_nodes
