"""Masked/batched kernel + GP math vs the naive compacted oracle."""
import numpy as np
import pytest

import jax.numpy as jnp

from gpismap.ops import gp, kernels

from naive_oracle import (gpou_fit_test, matern_cross, matern_train,
                          ongpis_fit_test, ou_train)

RNG = np.random.default_rng(0)


def _rand_nodes(m, d, frac_nograd=0.3):
    x = RNG.uniform(-1, 1, (m, d))
    grad = RNG.normal(size=(m, d))
    grad /= np.linalg.norm(grad, axis=-1, keepdims=True)
    # some nodes get no-grad markers (high noise or zero grad)
    nograd = RNG.uniform(size=m) < frac_nograd
    siggrad = np.where(nograd, 0.3, RNG.uniform(0.02, 0.09, m))
    zerog = RNG.uniform(size=m) < 0.1
    grad[zerog] = 0.0
    sigx = RNG.uniform(0.01, 0.1, m)
    val = RNG.normal(size=m) * 0.2
    return x, grad, val, sigx, siggrad


@pytest.mark.parametrize("d", [2, 3])
def test_matern_train_cov_matches_compacted(d):
    m = 7
    x, grad, val, sigx, siggrad = _rand_nodes(m, d)
    gradflag = (siggrad <= 0.1001) & ~np.all(np.abs(grad) < 1e-6, axis=-1)
    sigx_adj = np.where(~gradflag, 2.0, sigx)

    ref = matern_train(x, gradflag.astype(float), 1.2, sigx_adj, siggrad)

    valid = np.ones(m, bool)
    big = np.asarray(kernels.matern32_deriv_train_cov(
        jnp.asarray(x), jnp.asarray(sigx_adj), jnp.asarray(siggrad),
        jnp.asarray(gradflag), jnp.asarray(valid), 1.2))

    # extract the compacted submatrix from the masked layout:
    # rows [f_i for all i] + [g_ax,i for gradflag i]
    sel = list(range(m)) + [m * (1 + ax) + i for ax in range(d)
                            for i in range(m) if gradflag[i]]
    sub = big[np.ix_(sel, sel)]
    np.testing.assert_allclose(sub, ref, rtol=1e-5, atol=1e-6)

    # masked rows are exactly identity
    notsel = [i for i in range(m * (1 + d)) if i not in sel]
    for i in notsel:
        row = big[i].copy()
        assert row[i] == 1.0
        row[i] = 0.0
        assert np.all(row == 0.0)


@pytest.mark.parametrize("d", [2, 3])
def test_matern_cross_cov_matches_compacted(d):
    m, q = 6, 5
    x, grad, val, sigx, siggrad = _rand_nodes(m, d)
    gradflag = (siggrad <= 0.1001) & ~np.all(np.abs(grad) < 1e-6, axis=-1)
    xt = RNG.uniform(-1, 1, (q, d))

    ref = matern_cross(x, gradflag.astype(float), xt, 1.2)
    big = np.asarray(kernels.matern32_deriv_cross_cov(
        jnp.asarray(x), jnp.asarray(gradflag),
        jnp.asarray(np.ones(m, bool)), jnp.asarray(xt), 1.2))

    sel = list(range(m)) + [m * (1 + ax) + i for ax in range(d)
                            for i in range(m) if gradflag[i]]
    np.testing.assert_allclose(big[sel, :], ref, rtol=1e-5, atol=1e-6)


def test_ou_train_cov():
    m = 9
    x = RNG.uniform(-1, 1, (m, 1))
    sig = 0.01
    ref = ou_train(x, 0.5, sig)
    got = np.asarray(kernels.ou_train_cov(
        jnp.asarray(x), sig, jnp.ones(m, bool), 0.5))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [1, 2])
def test_gpou_padded_equals_unpadded(d):
    m, mpad, q = 11, 16, 7
    x = RNG.uniform(-1, 1, (m, d))
    f = RNG.normal(size=m)
    xt = RNG.uniform(-1, 1, (q, d))
    mean_ref, var_ref = gpou_fit_test(x, f, 0.5, 0.01, xt)

    xp = np.zeros((1, mpad, d))
    fp = np.zeros((1, mpad))
    valid = np.zeros((1, mpad), bool)
    xp[0, :m] = x
    fp[0, :m] = f
    valid[0, :m] = True
    st = gp.fit_gpou(jnp.asarray(xp), jnp.asarray(fp), jnp.asarray(valid),
                     0.5, 0.01)
    mean, var = gp.gpou_test(st, jnp.asarray(xt[None]), 0.5, 0.01)
    np.testing.assert_allclose(np.asarray(mean[0]), mean_ref, rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(var[0]), var_ref, rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("d", [2, 3])
def test_ongpis_padded_equals_compacted(d):
    m, mpad, q = 8, 12, 6
    x, grad, val, sigx, siggrad = _rand_nodes(m, d)
    xt = RNG.uniform(-1, 1, (q, d))
    scale = 1.2 if d == 2 else 0.04
    # 3D scale 0.04 with unit-scale coords gives wild exponents; shrink coords
    if d == 3:
        x = x * 0.02
        xt = xt * 0.02
    vc, gc = (1.01, 3.0 / scale**2 + 0.1) if d == 2 else \
             (1.001, 3.0 / scale**2 + 0.001)
    f_ref, g_ref, vf_ref, vg_ref = ongpis_fit_test(
        x, grad, val, sigx, siggrad, scale, xt, vc, gc)

    xp = np.zeros((1, mpad, d))
    gp_ = np.zeros((1, mpad, d))
    vp = np.zeros((1, mpad))
    sxp = np.zeros((1, mpad))
    sgp = np.zeros((1, mpad))
    valid = np.zeros((1, mpad), bool)
    xp[0, :m], gp_[0, :m], vp[0, :m] = x, grad, val
    sxp[0, :m], sgp[0, :m], valid[0, :m] = sigx, siggrad, True

    st = gp.fit_ongpis(jnp.asarray(xp), jnp.asarray(gp_), jnp.asarray(vp),
                       jnp.asarray(sxp), jnp.asarray(sgp),
                       jnp.asarray(valid), scale)
    f, g, vf, vg = gp.ongpis_test(st, jnp.asarray(xt[None]), scale, vc, gc)
    np.testing.assert_allclose(np.asarray(f[0]), f_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(g[0]), g_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(vf[0]), vf_ref, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(vg[0]), vg_ref, rtol=1e-3,
                               atol=2e-3)


def test_ongpis_zero_grad_nodes_get_value_only():
    # all-zero-gradient batch must still be positive definite & trainable
    m, d = 5, 2
    x = RNG.uniform(-1, 1, (1, m, d))
    grad = np.zeros((1, m, d))
    val = RNG.normal(size=(1, m))
    sigx = np.full((1, m), 0.05)
    siggrad = np.full((1, m), 0.05)
    valid = np.ones((1, m), bool)
    st = gp.fit_ongpis(jnp.asarray(x), jnp.asarray(grad), jnp.asarray(val),
                       jnp.asarray(sigx), jnp.asarray(siggrad),
                       jnp.asarray(valid), 1.2)
    assert np.all(np.isfinite(np.asarray(st.l)))
    assert not np.any(np.asarray(st.gradflag))
    f, g, vf, vg = gp.ongpis_test(st, jnp.asarray(x[:, :3]), 1.2, 1.01,
                                  3.0 / 1.44 + 0.1)
    assert np.all(np.isfinite(np.asarray(f)))
