"""REAL multi-process execution of the sharded query path (§5.8).

Spawns two OS processes, each owning 4 virtual CPU devices, brought up
with jax.distributed (Gloo collectives). Both controllers build the same
cluster-GP map, assemble a global query batch from process-local rows
(multihost.global_query_array), and run the actual
cluster.map_test_sharded over the 2-process/8-device mesh — including its
cross-process psum. Each process checks its local output rows against a
locally-computed single-device reference.

This is the executable form of the multihost.py recipe; a real pod slice
only swaps the CPU virtual devices for GPUs.
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from gpismap.parallel import multihost

multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
mesh = multihost.global_data_mesh()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_parallel import _circle_map
from gpismap.models import cluster

store, grid, kw = _circle_map()

rng = np.random.default_rng(0)
q = np.asarray(rng.uniform(-2, 2, (64, 2)), np.float32)
local_q = q[pid * 32:(pid + 1) * 32]          # this process's rows

g_store, g_grid = multihost.replicate(mesh, (store, grid))
g_q = multihost.global_query_array(mesh, local_q)

f8, _, v8, _, _ = cluster.map_test_sharded(g_store, g_grid, g_q,
                                           mesh=mesh, **kw)
f_loc = multihost.local_rows(f8)
v_loc = multihost.local_rows(v8)

# single-device reference, computed independently on this controller
f1, _, v1, _, _ = cluster.map_test(store, grid, jnp.asarray(q), **kw)
f1 = np.asarray(f1)[pid * 32:(pid + 1) * 32]
v1 = np.asarray(v1)[pid * 32:(pid + 1) * 32]
np.testing.assert_allclose(f_loc, f1, rtol=1e-5, atol=1e-5)
np.testing.assert_allclose(v_loc, v1, rtol=1e-5, atol=1e-5)
print(f"MULTIHOST_OK pid={pid}", flush=True)
"""


# The full ONLINE loop across 2 controllers: every process ingests the
# same 4 gazebo frames with the real mapper (deterministic host replay,
# multihost.py:10-13), proves its map state equals the other controller's
# THROUGH a collective (not just by construction), then answers a sharded
# query batch against the replicated store.
_UPDATE_WORKER = r"""
import os, sys, hashlib
pid = int(sys.argv[1]); port = sys.argv[2]
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from gpismap.parallel import multihost

multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=pid)
assert jax.process_count() == 2
mesh = multihost.global_data_mesh()
n_local_dev = len(jax.local_devices())

from gpismap import datasets
from gpismap.api import GPisMap2D
from gpismap.models import cluster

m = GPisMap2D()
for fr in list(datasets.gazebo_frames())[:4]:
    m.update(fr.thetas, fr.ranges, fr.pose)

# digest the full map state this controller replayed
d = m.index.dump_nodes()
alive = d["alive"]
h = hashlib.sha256()
for k in ("pos", "val", "grad", "pos_sig", "grad_sig"):
    h.update(np.ascontiguousarray(d[k][alive]).tobytes())
h.update(np.asarray(m.store.alpha).tobytes())
h.update(np.asarray(m.store.trained).tobytes())

# cross-controller equality via a real collective: shard both digests
# over the global mesh, reduce max-min per byte -> all zeros iff equal
dg = np.frombuffer(h.digest(), np.uint8).astype(np.float32)
rows = np.repeat(dg[None], n_local_dev, 0)
g = multihost.global_query_array(mesh, rows)
spread = jax.jit(lambda a: jnp.max(a, 0) - jnp.min(a, 0))(g)
assert np.asarray(spread).max() == 0.0, "controllers diverged"
print(f"REPLAY_IDENTICAL pid={pid} nodes={int(alive.sum())}", flush=True)

# sharded query against the replicated store (the serving path)
xtest, _ = datasets.gazebo_test_grid()
qp = 2048
xq = np.full((qp, 2), 1e6, np.float32)
xq[:qp] = xtest[::24][:qp]
local_q = xq[pid * (qp // 2):(pid + 1) * (qp // 2)]

g_store, g_grid = multihost.replicate(mesh, (m.store, m.grid))
g_q = multihost.global_query_array(mesh, local_q)
f8, _, v8, _, _ = cluster.map_test_sharded(g_store, g_grid, g_q,
                                           mesh=mesh, **m._test_kwargs())
f_loc = multihost.local_rows(f8)
v_loc = multihost.local_rows(v8)

ref = m.test(xq)                 # local single-process reference
sl = slice(pid * (qp // 2), (pid + 1) * (qp // 2))
np.testing.assert_allclose(f_loc, ref[sl, 0], rtol=1e-5, atol=1e-5)
np.testing.assert_allclose(v_loc, ref[sl, 3], rtol=1e-5, atol=1e-5)
print(f"MULTIHOST_UPDATE_OK pid={pid}", flush=True)
"""


# 3D twin of _UPDATE_WORKER: the full GPisMap3D online loop (camera
# projection, hybrid re-eval, octree replay) crosses the controller
# boundary — reference threading parity: GPisMap3.cpp:720-792,904-949.
_UPDATE_WORKER_3D = r"""
import os, sys, hashlib
pid = int(sys.argv[1]); port = sys.argv[2]
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from gpismap.parallel import multihost

multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=pid)
assert jax.process_count() == 2
mesh = multihost.global_data_mesh()
n_local_dev = len(jax.local_devices())

from gpismap import datasets
from gpismap.api3d import GPisMap3D
from gpismap.models import cluster

m = GPisMap3D()
for fr in list(datasets.bigbird_frames())[:4]:
    m.set_camera(fr.cam_id, "bigbird")
    m.update(fr.depth, fr.pose)

d = m.index.dump_nodes()
alive = d["alive"]
h = hashlib.sha256()
for k in ("pos", "val", "grad", "pos_sig", "grad_sig"):
    h.update(np.ascontiguousarray(d[k][alive]).tobytes())
h.update(np.asarray(m.store.alpha).tobytes())
h.update(np.asarray(m.store.trained).tobytes())

dg = np.frombuffer(h.digest(), np.uint8).astype(np.float32)
rows = np.repeat(dg[None], n_local_dev, 0)
g = multihost.global_query_array(mesh, rows)
spread = jax.jit(lambda a: jnp.max(a, 0) - jnp.min(a, 0))(g)
assert np.asarray(spread).max() == 0.0, "controllers diverged"
print(f"REPLAY_IDENTICAL pid={pid} nodes={int(alive.sum())}", flush=True)

xtest, _ = datasets.bigbird_test_grid()
qp = 1024
xq = np.full((qp, 3), 1e6, np.float32)
xq[:qp] = xtest[::14][:qp]
local_q = xq[pid * (qp // 2):(pid + 1) * (qp // 2)]

g_store, g_grid = multihost.replicate(mesh, (m.store, m.grid))
g_q = multihost.global_query_array(mesh, local_q)
f8, _, v8, _, _ = cluster.map_test_sharded(g_store, g_grid, g_q,
                                           mesh=mesh, **m._test_kwargs())
f_loc = multihost.local_rows(f8)
v_loc = multihost.local_rows(v8)

ref = m.test(xq)
sl = slice(pid * (qp // 2), (pid + 1) * (qp // 2))
np.testing.assert_allclose(f_loc, ref[sl, 0], rtol=1e-5, atol=1e-5)
np.testing.assert_allclose(v_loc, ref[sl, 4], rtol=1e-5, atol=1e-5)
print(f"MULTIHOST3D_UPDATE_OK pid={pid}", flush=True)
"""


def _run_two_process(worker_src, ok_marker, timeout=600):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tests = os.path.join(repo, "tests")
    worker = os.path.join(tests, "_multihost_worker.py")
    with open(worker, "w") as fh:
        fh.write(worker_src)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), port], cwd=tests,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"{ok_marker} pid={pid}" in out, out
    return outs


def test_two_process_sharded_query():
    _run_two_process(_WORKER, "MULTIHOST_OK", timeout=300)


@pytest.mark.slow
def test_two_process_online_update_loop():
    """Executes the multihost.py:10-13 claim: the deterministic host
    replay keeps both controllers' maps identical (checked through a
    collective on a state digest), and the replicated store then serves a
    sharded query batch matching each controller's local reference."""
    outs = _run_two_process(_UPDATE_WORKER, "MULTIHOST_UPDATE_OK")
    for out in outs:
        assert "REPLAY_IDENTICAL" in out, out


@pytest.mark.slow
def test_two_process_online_update_loop_3d():
    """3D twin: 4 bigbird frames replayed on each controller, state
    digests proven equal through a collective, then a sharded 3D query
    batch served from the replicated store."""
    outs = _run_two_process(_UPDATE_WORKER_3D, "MULTIHOST3D_UPDATE_OK",
                            timeout=900)
    for out in outs:
        assert "REPLAY_IDENTICAL" in out, out
