"""ctypes binding for the native spatial index (csrc/gpis_index.cpp).

The index is the host-side runtime component of the framework: it owns the
authoritative node store and the adaptive 2^D-tree with the reference's
insert/dedup/remove semantics (reference: cpp/src/quadtree.cpp,
cpp/src/octree.cpp), and produces the flat padded arrays (retrain batches,
support CSR, cluster-cell tables) that feed the device compute.

The shared library is built lazily with `make` on first use, named by a
hash of gpis_index.cpp and the Makefile: a checkout copied to another host
with other sources, or a library built from older ones, never loads a
stale build, and concurrent first uses each build to a private file and
rename it into place.
"""
from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ..config import TreeParam

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc")
_LOCK = threading.Lock()
_LIB: Optional[ct.CDLL] = None

_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def lib_path() -> str:
    """The library built from the current gpis_index.cpp and Makefile."""
    h = hashlib.sha256()
    for name in ("gpis_index.cpp", "Makefile"):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(_CSRC, f"libgpis_index-{h.hexdigest()[:16]}.so")


def _load() -> ct.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = lib_path()
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run(["make", "-C", _CSRC, f"OUT={tmp}"], check=True,
                           capture_output=True)
            os.replace(tmp, path)
        lib = ct.CDLL(path)

        lib.gpis_index_create.restype = ct.c_void_p
        lib.gpis_index_create.argtypes = [
            ct.c_int, ct.c_float, ct.c_float, ct.c_float, ct.c_float,
            ct.c_float, ct.c_int]
        lib.gpis_index_destroy.argtypes = [ct.c_void_p]
        lib.gpis_index_reset.argtypes = [ct.c_void_p]
        lib.gpis_index_try_insert.argtypes = [ct.c_void_p, _F32P, ct.c_int,
                                              _I32P]
        lib.gpis_index_set_node_data.argtypes = [
            ct.c_void_p, _I32P, ct.c_int, _F32P, _F32P, _F32P, _F32P]
        lib.gpis_index_update_noise.argtypes = [ct.c_void_p, _I32P, ct.c_int,
                                                _F32P, _F32P]
        lib.gpis_index_remove.argtypes = [ct.c_void_p, _I32P, ct.c_int]
        lib.gpis_index_num_nodes.restype = ct.c_int
        lib.gpis_index_num_nodes.argtypes = [ct.c_void_p]
        lib.gpis_index_node_capacity.restype = ct.c_int
        lib.gpis_index_node_capacity.argtypes = [ct.c_void_p]
        lib.gpis_index_dump_nodes.argtypes = [
            ct.c_void_p, _F32P, _F32P, _F32P, _F32P, _F32P, _U8P]
        lib.gpis_index_get_nodes.argtypes = [
            ct.c_void_p, _I32P, ct.c_int, _F32P, _F32P, _F32P, _F32P,
            _F32P, _U8P]
        lib.gpis_index_query_range.restype = ct.c_int
        lib.gpis_index_query_range.argtypes = [ct.c_void_p, _F32P, ct.c_float,
                                               _I32P, ct.c_int]
        lib.gpis_index_query_cluster_cells.restype = ct.c_int
        lib.gpis_index_query_cluster_cells.argtypes = [
            ct.c_void_p, _F32P, ct.c_float, _I32P, _F32P, ct.c_int]
        lib.gpis_index_num_active.restype = ct.c_int
        lib.gpis_index_num_active.argtypes = [ct.c_void_p]
        lib.gpis_index_get_active.restype = ct.c_int
        lib.gpis_index_get_active.argtypes = [ct.c_void_p, _I32P, ct.c_int]
        lib.gpis_index_clear_active.argtypes = [ct.c_void_p]
        lib.gpis_index_cell_info.argtypes = [ct.c_void_p, _I32P, ct.c_int,
                                             _F32P, _F32P, _I32P]
        lib.gpis_index_all_cluster_cells.restype = ct.c_int
        lib.gpis_index_all_cluster_cells.argtypes = [ct.c_void_p, _I32P,
                                                     ct.c_int]
        lib.gpis_index_collect_retrain.restype = ct.c_int
        lib.gpis_index_collect_retrain.argtypes = [
            ct.c_void_p, ct.c_float, ct.c_int, ct.c_int, _I32P, _I32P, _F32P,
            _I32P, _I32P]
        lib.gpis_index_apply_reeval.argtypes = [
            ct.c_void_p, _I32P, ct.c_int, _I32P, _F32P, _F32P, _F32P, _F32P,
            _F32P, _F32P, ct.c_float, _I32P]
        lib.gpis_index_cell_nodes.restype = ct.c_int
        lib.gpis_index_cell_nodes.argtypes = [ct.c_void_p, ct.c_int, _I32P,
                                              ct.c_int]
        lib.gpis_index_overflow_count.restype = ct.c_longlong
        lib.gpis_index_overflow_count.argtypes = [ct.c_void_p]
        lib.gpis_index_max_slot.restype = ct.c_int
        lib.gpis_index_max_slot.argtypes = [ct.c_void_p]
        lib.gpis_index_serialize_size.restype = ct.c_longlong
        lib.gpis_index_serialize_size.argtypes = [ct.c_void_p]
        lib.gpis_index_serialize.argtypes = [ct.c_void_p, _U8P]
        lib.gpis_index_deserialize.restype = ct.c_int
        lib.gpis_index_deserialize.argtypes = [ct.c_void_p, _U8P,
                                               ct.c_longlong]
        _LIB = lib
        return lib


class SpatialIndex:
    """Handle to one native tree (2D quadtree / 3D octree semantics)."""

    def __init__(self, dim: int, tree: TreeParam, max_slots: int = 1 << 20):
        self._lib = _load()
        self.dim = dim
        # cluster-level epsilon: 1e-3 in 2D (quadtree.cpp:238), 1e-6 in 3D
        # (octree.cpp:325) — both far below any real level gap
        eps = 1e-3 if dim == 2 else 1e-6
        self._h = self._lib.gpis_index_create(
            dim, tree.min_halfleng, tree.max_halfleng,
            tree.init_root_halfleng, tree.cluster_halfleng, eps, max_slots)
        # node ids mutated since the last pop_dirty (drives the device
        # node-table mirror; api._sync_mirror)
        self._dirty: list = []
        # capped host queries that had to re-issue with a larger buffer
        # (see the auto-regrow note above the query methods)
        self.regrow_count = 0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gpis_index_destroy(self._h)
            self._h = None

    def reset(self):
        self._lib.gpis_index_reset(self._h)
        self._dirty = []

    # -- mutation --
    def try_insert(self, pos: np.ndarray) -> np.ndarray:
        """Sequential IsNotNew+Insert per row. Returns node ids
        (-2 duplicate, -1 failed)."""
        pos = np.ascontiguousarray(pos, np.float32)
        out = np.empty(pos.shape[0], np.int32)
        self._lib.gpis_index_try_insert(self._h, pos, pos.shape[0], out)
        self._dirty.append(out[out >= 0].copy())
        return out

    def set_node_data(self, ids, val, pos_sig, grad, grad_sig):
        ids = np.ascontiguousarray(ids, np.int32)
        self._dirty.append(ids.copy())
        self._lib.gpis_index_set_node_data(
            self._h, ids, ids.shape[0],
            np.ascontiguousarray(val, np.float32),
            np.ascontiguousarray(pos_sig, np.float32),
            np.ascontiguousarray(grad, np.float32),
            np.ascontiguousarray(grad_sig, np.float32))

    def update_noise(self, ids, pos_sig, grad_sig):
        ids = np.ascontiguousarray(ids, np.int32)
        self._dirty.append(ids.copy())
        self._lib.gpis_index_update_noise(
            self._h, ids, ids.shape[0],
            np.ascontiguousarray(pos_sig, np.float32),
            np.ascontiguousarray(grad_sig, np.float32))

    def remove(self, ids):
        ids = np.ascontiguousarray(ids, np.int32)
        self._lib.gpis_index_remove(self._h, ids, ids.shape[0])

    # -- introspection --
    @property
    def num_nodes(self) -> int:
        return self._lib.gpis_index_num_nodes(self._h)

    @property
    def node_capacity(self) -> int:
        return self._lib.gpis_index_node_capacity(self._h)

    @property
    def max_slot(self) -> int:
        return self._lib.gpis_index_max_slot(self._h)

    @property
    def overflow_count(self) -> int:
        return self._lib.gpis_index_overflow_count(self._h)

    def dump_nodes(self):
        """All node rows (row index == node id); `alive` marks valid rows."""
        cap = max(self.node_capacity, 1)
        pos = np.zeros((cap, self.dim), np.float32)
        grad = np.zeros((cap, self.dim), np.float32)
        val = np.zeros(cap, np.float32)
        ps = np.zeros(cap, np.float32)
        gs = np.zeros(cap, np.float32)
        alive = np.zeros(cap, np.uint8)
        if self.node_capacity:
            self._lib.gpis_index_dump_nodes(self._h, pos, grad, val, ps, gs,
                                            alive)
        return dict(pos=pos, grad=grad, val=val, pos_sig=ps, grad_sig=gs,
                    alive=alive.astype(bool))

    def get_nodes(self, ids: np.ndarray):
        """Gather node rows for an id list (padded/invalid ids -> zeros)."""
        ids = np.ascontiguousarray(ids, np.int32)
        n = ids.shape[0]
        pos = np.zeros((n, self.dim), np.float32)
        grad = np.zeros((n, self.dim), np.float32)
        val = np.zeros(n, np.float32)
        ps = np.zeros(n, np.float32)
        gs = np.zeros(n, np.float32)
        alive = np.zeros(n, np.uint8)
        if n:
            self._lib.gpis_index_get_nodes(self._h, ids, n, pos, grad, val,
                                           ps, gs, alive)
        return dict(pos=pos, grad=grad, val=val, pos_sig=ps, grad_sig=gs,
                    alive=alive.astype(bool))

    # -- queries --
    # Every capped query below auto-regrows: the C functions return the
    # FULL match count, so a result larger than the buffer re-issues the
    # call at the exact size (and counts the event in regrow_count) —
    # a truncated result is impossible to hit silently (the repo-wide
    # no-silent-caps policy; cf. nbr_overflow / retrain_truncated).
    def query_range(self, center, half: float, cap: int = 4096):
        center = np.ascontiguousarray(center, np.float32)
        out = np.empty(cap, np.int32)
        n = self._lib.gpis_index_query_range(self._h, center, half, out, cap)
        if n > cap:
            self.regrow_count += 1
            out = np.empty(n, np.int32)
            n = self._lib.gpis_index_query_range(self._h, center, half, out,
                                                 n)
        return out[:n].copy()

    def query_cluster_cells(self, center, half: float, cap: int = 4096):
        center = np.ascontiguousarray(center, np.float32)
        out = np.empty(cap, np.int32)
        dst = np.empty(cap, np.float32)
        n = self._lib.gpis_index_query_cluster_cells(self._h, center, half,
                                                     out, dst, cap)
        if n > cap:
            self.regrow_count += 1
            out = np.empty(n, np.int32)
            dst = np.empty(n, np.float32)
            n = self._lib.gpis_index_query_cluster_cells(
                self._h, center, half, out, dst, n)
        return out[:n].copy(), dst[:n].copy()

    def active_cells(self, cap: int = 65536) -> np.ndarray:
        out = np.empty(cap, np.int32)
        n = self._lib.gpis_index_get_active(self._h, out, cap)
        if n > cap:
            self.regrow_count += 1
            out = np.empty(n, np.int32)
            n = self._lib.gpis_index_get_active(self._h, out, n)
        return out[:n].copy()

    def clear_active(self):
        self._lib.gpis_index_clear_active(self._h)

    def cell_info(self, cells) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        cells = np.ascontiguousarray(cells, np.int32)
        n = cells.shape[0]
        centers = np.empty((n, self.dim), np.float32)
        halfs = np.empty(n, np.float32)
        slots = np.empty(n, np.int32)
        if n:
            self._lib.gpis_index_cell_info(self._h, cells, n, centers, halfs,
                                           slots)
        return centers, halfs, slots

    def all_cluster_cells(self, cap: int = 65536) -> np.ndarray:
        out = np.empty(cap, np.int32)
        n = self._lib.gpis_index_all_cluster_cells(self._h, out, cap)
        if n > cap:
            self.regrow_count += 1
            out = np.empty(n, np.int32)
            n = self._lib.gpis_index_all_cluster_cells(self._h, out, n)
        return out[:n].copy()

    def apply_reeval(self, ids, actions, pos, grad, noise, grad_noise,
                     dbl_ps, dbl_gs, fused_val: float) -> np.ndarray:
        """Apply per-node re-evaluation outcomes in reference order
        (GPisMap.cpp:398-452). Returns new node ids for re-inserts."""
        ids = np.ascontiguousarray(ids, np.int32)
        self._dirty.append(ids.copy())
        out = np.empty(ids.shape[0], np.int32)
        self._lib.gpis_index_apply_reeval(
            self._h, ids, ids.shape[0],
            np.ascontiguousarray(actions, np.int32),
            np.ascontiguousarray(pos, np.float32),
            np.ascontiguousarray(grad, np.float32),
            np.ascontiguousarray(noise, np.float32),
            np.ascontiguousarray(grad_noise, np.float32),
            np.ascontiguousarray(dbl_ps, np.float32),
            np.ascontiguousarray(dbl_gs, np.float32),
            float(fused_val), out)
        self._dirty.append(out[out >= 0].copy())
        return out

    def cell_nodes(self, cell: int, cap: int = 4096) -> np.ndarray:
        """Node ids in a cell's subtree, DFS order
        (getAllChildrenNonEmptyNodes, quadtree.cpp:597-613)."""
        out = np.empty(cap, np.int32)
        n = self._lib.gpis_index_cell_nodes(self._h, int(cell), out, cap)
        if n > cap:
            self.regrow_count += 1
            out = np.empty(n, np.int32)
            n = self._lib.gpis_index_cell_nodes(self._h, int(cell), out, n)
        return out[:n].copy()

    def serialize(self) -> np.ndarray:
        """Full tree state as a byte blob (exact restore incl. node ids,
        cell structure and slots)."""
        n = self._lib.gpis_index_serialize_size(self._h)
        buf = np.empty(n, np.uint8)
        self._lib.gpis_index_serialize(self._h, buf)
        return buf

    def pop_dirty(self) -> np.ndarray:
        """Unique node ids mutated since the last call (clears the set)."""
        if not self._dirty:
            return np.zeros(0, np.int32)
        ids = np.unique(np.concatenate(self._dirty)).astype(np.int32)
        self._dirty = []
        return ids[ids >= 0]

    def deserialize(self, blob: np.ndarray) -> None:
        blob = np.ascontiguousarray(blob, np.uint8)
        rc = self._lib.gpis_index_deserialize(self._h, blob, blob.shape[0])
        if rc != 0:
            raise ValueError("invalid index checkpoint blob")

    def collect_retrain(self, radius_times: float, support_cap: int,
                        cell_cap: int):
        """Dilated active set + per-cell support lists
        (reference: GPisMap.cpp:574-616). Returns dict with padded arrays."""
        cells = np.empty(cell_cap, np.int32)
        slots = np.empty(cell_cap, np.int32)
        centers = np.empty((cell_cap, self.dim), np.float32)
        support = np.empty((cell_cap, support_cap), np.int32)
        counts = np.empty(cell_cap, np.int32)
        n = self._lib.gpis_index_collect_retrain(
            self._h, radius_times, support_cap, cell_cap, cells, slots,
            centers, support, counts)
        b = min(n, cell_cap)
        return dict(n=b, total=n, cells=cells[:b].copy(),
                    slots=slots[:b].copy(), centers=centers[:b].copy(),
                    support=support[:b].copy(), counts=counts[:b].copy())
