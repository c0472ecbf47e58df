"""Naive NumPy oracle implementing the reference GP math with explicit
gradflag compaction, exactly as described by cpp/src/covFnc.cpp and
cpp/src/OnGPIS.cpp / ObsGP.cpp. Used only by tests to validate that the
masked/padded batched formulation reproduces the compacted system bit-for-bit
(up to float tolerance).

Written independently from the closed forms; loops are intentionally slow
and simple.
"""
import numpy as np

SQRT3 = np.sqrt(3.0)


def kf(r, a):
    return (1.0 + a * r) * np.exp(-a * r)


def kf1(r, dx, a):
    return a * a * dx * np.exp(-a * r)


def kf2(r, dx1, dx2, delta, a):
    return a * a * (delta - a * dx1 * dx2 / r) * np.exp(-a * r)


def ou_train(x, scale, sig):
    """x: [M, D]; sig scalar or [M]. covFnc.cpp:47-91."""
    m = x.shape[0]
    sig = np.broadcast_to(np.asarray(sig, np.float64), (m,))
    k = np.zeros((m, m))
    for i in range(m):
        for j in range(m):
            if i == j:
                k[i, i] = 1.0 + sig[i]
            else:
                r = np.linalg.norm(x[i] - x[j])
                k[i, j] = np.exp(-r / scale)
    return k


def ou_cross(x1, x2, scale):
    n, m = x1.shape[0], x2.shape[0]
    k = np.zeros((n, m))
    for i in range(n):
        for j in range(m):
            k[i, j] = np.exp(-np.linalg.norm(x1[i] - x2[j]) / scale)
    return k


def matern_train(x, gradflag, scale, sigx, siggrad):
    """Compacted joint covariance, covFnc.cpp:141-402. x: [M, D]."""
    m, d = x.shape
    a = SQRT3 / scale
    gidx = -np.ones(m, dtype=int)
    ng = 0
    for i in range(m):
        if gradflag[i] > 0.5:
            gidx[i] = ng
            ng += 1
    size = m + ng * d
    k = np.zeros((size, size))
    for i in range(m):
        for j in range(m):
            if i == j:
                k[i, i] = 1.0 + sigx[i]
                if gidx[i] >= 0:
                    for ax in range(d):
                        ii = m + gidx[i] + ax * ng
                        if d == 2 and ax == 0:
                            k[ii, ii] = a * a + np.sqrt(sigx[i] * siggrad[i])
                        else:
                            k[ii, ii] = a * a + siggrad[i]
                continue
            r = np.linalg.norm(x[i] - x[j])
            k[i, j] = kf(r, a)
            if gidx[i] >= 0:
                for ax in range(d):
                    ii = m + gidx[i] + ax * ng
                    k[ii, j] = -kf1(r, x[i, ax] - x[j, ax], a)
                    k[j, ii] = k[ii, j]
                if gidx[j] >= 0:
                    for ax1 in range(d):
                        ii = m + gidx[i] + ax1 * ng
                        for ax2 in range(d):
                            jj = m + gidx[j] + ax2 * ng
                            k[ii, jj] = kf2(r, x[i, ax1] - x[j, ax1],
                                            x[i, ax2] - x[j, ax2],
                                            1.0 if ax1 == ax2 else 0.0, a)
            elif gidx[j] >= 0:
                for ax in range(d):
                    jj = m + gidx[j] + ax * ng
                    k[i, jj] = kf1(r, x[i, ax] - x[j, ax], a)
    return k


def matern_cross(x, gradflag, xt, scale):
    """Compacted cross covariance, covFnc.cpp:258-314,404-450.

    x: [M, D] train; xt: [Q, D] test. Returns [M + ng*D, Q*(1+D)].
    """
    m, d = x.shape
    q = xt.shape[0]
    a = SQRT3 / scale
    gidx = -np.ones(m, dtype=int)
    ng = 0
    for i in range(m):
        if gradflag[i] > 0.5:
            gidx[i] = ng
            ng += 1
    k = np.zeros((m + ng * d, q * (1 + d)))
    for i in range(m):
        for j in range(q):
            r = np.linalg.norm(x[i] - xt[j])
            k[i, j] = kf(r, a)
            for ax in range(d):
                k[i, j + (1 + ax) * q] = kf1(r, x[i, ax] - xt[j, ax], a)
            if gidx[i] >= 0:
                for ax1 in range(d):
                    ii = m + gidx[i] + ax1 * ng
                    k[ii, j] = -k[i, j + (1 + ax1) * q]
                    for ax2 in range(d):
                        k[ii, j + (1 + ax2) * q] = kf2(
                            r, x[i, ax1] - xt[j, ax1],
                            x[i, ax2] - xt[j, ax2],
                            1.0 if ax1 == ax2 else 0.0, a)
    return k


def ongpis_fit_test(x, grad, val, sigx, siggrad, scale, xt,
                    val_const, grad_const):
    """Full compacted OnGPIS train + test (OnGPIS.cpp). Returns
    (f [Q], grad [Q, D], varf [Q], vargrad [Q, D])."""
    m, d = x.shape
    q = xt.shape[0]
    sigx = sigx.copy()
    gradflag = np.zeros(m)
    gvals = []
    for i in range(m):
        if siggrad[i] > 0.1001 or np.all(np.abs(grad[i]) < 1e-6):
            gradflag[i] = 0.0
            sigx[i] = 2.0
        else:
            gradflag[i] = 1.0
            gvals.append(grad[i])
    gvals = np.asarray(gvals).reshape(-1, d) if gvals else np.zeros((0, d))
    y = np.concatenate([val] + [gvals[:, ax] for ax in range(d)])
    k = matern_train(x, gradflag, scale, sigx, siggrad)
    lo = np.linalg.cholesky(k)
    alpha = np.linalg.solve(lo.T, np.linalg.solve(lo, y))
    ks = matern_cross(x, gradflag, xt, scale)
    res = ks.T @ alpha
    f = res[:q]
    g = np.stack([res[(1 + ax) * q:(2 + ax) * q] for ax in range(d)], axis=-1)
    v = np.linalg.solve(lo, ks)
    vs = np.sum(v * v, axis=0)
    varf = val_const - vs[:q]
    vargrad = np.stack([grad_const - vs[(1 + ax) * q:(2 + ax) * q]
                        for ax in range(d)], axis=-1)
    return f, g, varf, vargrad


def gpou_fit_test(x, f, scale, noise, xt):
    """GPou train+test (ObsGP.cpp:32-62)."""
    k = ou_train(x, scale, noise)
    lo = np.linalg.cholesky(k)
    alpha = np.linalg.solve(lo.T, np.linalg.solve(lo, f))
    ks = ou_cross(x, xt, scale)
    mean = ks.T @ alpha
    v = np.linalg.solve(lo, ks)
    var = 1.0 + noise - np.sum(v * v, axis=0)
    return mean, var
