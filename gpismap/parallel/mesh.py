"""Multi-chip sharding for the GPIS pipeline.

The reference's only parallelism is a std::thread fan-out over query chunks
and cluster cells with a join barrier (reference: GPisMap.cpp:596-663,
765-810 — C13 in SURVEY.md). The equivalent here is data-parallel
sharding over a jax.sharding.Mesh:

  * test(): query points sharded over the mesh, cluster-GP store and grid
    replicated — zero cross-chip traffic in the hot loop, exactly the
    moral equivalent of test_kernel chunking.
  * update(): beams/nodes/retrain-cells sharded; the observation GP is
    replicated (it is tiny); scalar frame statistics all-reduce.

Shardings are expressed with NamedSharding + jax.jit so XLA inserts the
collectives; no hand-written NCCL-style code.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import cluster


def data_mesh(devices=None, axis: str = "d") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def sharded_map_test(store: cluster.ClusterStore, grid: jnp.ndarray,
                     q: jnp.ndarray, mesh: Mesh, **kw):
    """map_test with queries sharded over the mesh, store replicated."""
    axis = mesh.axis_names[0]
    qsh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    q = jax.device_put(q, qsh)
    store = jax.device_put(store, rep)
    grid = jax.device_put(grid, rep)
    return cluster.map_test(store, grid, q, **kw)
