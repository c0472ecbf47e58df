"""Every contraction on the GP fit and query paths runs at the precision
that ops/precision.py owns (float32 HIGHEST): a float32 dot left at
DEFAULT may run in TF32 on a GPU."""
import jax
from jax.extend import core as jex_core
import jax.numpy as jnp
import numpy as np
import pytest

from gpismap.ops import precision
from test_parallel import _circle_map


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a jaxpr, sub-jaxprs
    (scan / cond / while / pjit / custom rules) included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jex_core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jex_core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _assert_all_owned(fn, *args, expect_dots=True):
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert bool(precs) == expect_dots, precs
    want = (precision.MATMUL, precision.MATMUL)
    bad = [p for p in precs if p != want]
    assert not bad, f"{len(bad)} of {len(precs)} dots not at HIGHEST: {bad}"


def test_map_test_contractions_use_owned_precision():
    from gpismap.models import cluster

    store, grid, kw = _circle_map()
    q = jnp.asarray(np.random.default_rng(0).uniform(-2, 2, (64, 2)),
                    jnp.float32)
    _assert_all_owned(
        lambda s, g, x: cluster.map_test(s, g, x, **kw)[:4], store, grid, q)


@pytest.mark.parametrize("d", [2, 3])
def test_retrain_fit_contractions_use_owned_precision(d):
    from gpismap.config import CapacityParam
    from gpismap.models import cluster

    cap = CapacityParam(gp_support=16, retrain_batch=8, max_cells=32,
                        max_nodes=256, test_tile=16, test_active_cells=16)
    rng = np.random.default_rng(1)
    b, m = 4, cap.gp_support
    x = jnp.asarray(rng.uniform(-1, 1, (b, m, d)), jnp.float32)
    g = jnp.asarray(rng.normal(size=(b, m, d)), jnp.float32)
    ones = jnp.ones((b, m), jnp.float32)
    slots = jnp.arange(b, dtype=jnp.int32)

    def fit(store, x, g):
        st, l = cluster._retrain_impl(store, slots, slots >= 0, x, g,
                                      -0.2 * ones, 0.05 * ones, 0.05 * ones,
                                      ones > 0, 0.8)
        return st.alpha, gp_linv(l)

    from gpismap.ops.gp import linv_from_chol as gp_linv
    # today the fit's contractions are all Cholesky and triangular
    # solves: a dot added to it must come in at the owned precision
    _assert_all_owned(fit, cluster.make_store(cap, d), x, g,
                      expect_dots=False)


def test_frame_programs_use_owned_precision():
    """The per-frame device programs (observation-GP fit, re-evaluation,
    new measurements) of both mappers."""
    from gpismap.config import MAPPER_2D, MAPPER_3D, OBSGP_1D, OBSGP_2D
    from gpismap.models import mapper2d, mapper3d
    from workloads import SMALL_CAM, frames_2d, frames_3d

    th, rg, pose = frames_2d(1)[0]
    nb = 2048
    th_p = np.zeros(nb, np.float32)
    rg_p = np.zeros(nb, np.float32)
    th_p[:len(th)], rg_p[:len(rg)] = th, rg
    rot = pose[2:6].reshape(2, 2, order="F")
    _assert_all_owned(
        lambda a, b, t, r: mapper2d.frame_compute_2d(
            a, b, t, r, MAPPER_2D, OBSGP_1D, g_max=nb // 20 + 2),
        th_p, rg_p, pose[:2], rot)

    depth, pose, _ = frames_3d(1)[0]
    rot = pose[3:12].reshape(3, 3, order="F")
    for blocked in (False, True):
        _assert_all_owned(
            lambda z, t, r: mapper3d.frame_compute_3d(
                z, t, r, SMALL_CAM, MAPPER_3D, OBSGP_2D, blocked=blocked),
            depth, pose[:3], rot)
