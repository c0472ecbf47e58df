"""Partitioned observation GP vs a naive per-group oracle that follows the
reference partition rules literally (ObsGP.cpp:85-187, :204-463)."""
import numpy as np
import jax.numpy as jnp

from gpismap.config import OBSGP_1D, OBSGP_2D
from gpismap.models import obsgp
from naive_oracle import gpou_fit_test

RNG = np.random.default_rng(3)


def naive_obsgp1d(theta, f, q, p):
    """Literal transcription of the 1D partition + lookup logic."""
    n = len(theta)
    gs, ov = p.group_size, p.overlap
    n_group = n // gs + 1
    groups = []        # (x, f) slices
    rng = [theta[0]]
    nn = 0
    while nn < n_group - 1:
        if nn < n_group - 2:
            i1 = nn * gs
            i2 = i1 + gs + ov
            rng.append(theta[i2 - ov // 2])
            groups.append((theta[i1:i1 + gs + ov], f[i1:i1 + gs + ov]))
        else:
            i1 = nn * gs
            i2 = i1 + (n - i1) // 2 + ov
            rng.append(theta[i2 - ov // 2])
            groups.append((theta[i1:i2 + 1], f[i1:i2 + 1]))
            nn += 1
            i1b = i1 + (n - i1) // 2
            i2b = n - 1
            rng.append(theta[i2b])
            groups.append((theta[i1b:i2b + 1], f[i1b:i2b + 1]))
        nn += 1
    mean = np.zeros(len(q))
    var = np.full(len(q), 1e6)
    if n_group < 2:
        return mean, var
    liml, limr = rng[0] + p.margin, rng[-1] - p.margin
    for k, x in enumerate(q):
        if x < liml or x > limr:
            continue
        for j in range(len(rng) - 1):
            if rng[j] < x < rng[j + 1]:
                gx, gf = groups[j]
                m, v = gpou_fit_test(gx[:, None], gf, p.scale, p.noise,
                                     np.array([[x]]))
                mean[k], var[k] = m[0], v[0]
                break
    return mean, var


def test_obsgp1d_matches_naive():
    n = 67
    theta = np.sort(RNG.uniform(-2, 2, n))
    f = np.sin(theta) + 0.05 * RNG.normal(size=n)
    q = RNG.uniform(-2.2, 2.2, 200)

    m_ref, v_ref = naive_obsgp1d(theta, f, q, OBSGP_1D)

    st = obsgp.fit_obsgp1d(jnp.asarray(theta, jnp.float32),
                           jnp.asarray(f, jnp.float32),
                           jnp.ones(n, bool), OBSGP_1D)
    m, v = obsgp.obsgp1d_test(st, jnp.asarray(q, jnp.float32), OBSGP_1D,
                              chunk=64)
    m, v = np.asarray(m), np.asarray(v)
    inval_ref = v_ref >= 1e5
    inval = v >= 1e5
    np.testing.assert_array_equal(inval, inval_ref)
    ok = ~inval
    np.testing.assert_allclose(m[ok], m_ref[ok], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(v[ok], v_ref[ok], rtol=2e-3, atol=2e-3)


def test_obsgp1d_with_invalid_beams():
    n = 80
    theta = np.sort(RNG.uniform(-2, 2, n))
    f = np.cos(theta)
    valid = RNG.uniform(size=n) > 0.3
    q = RNG.uniform(-2, 2, 50)

    m_ref, v_ref = naive_obsgp1d(theta[valid], f[valid], q, OBSGP_1D)
    st = obsgp.fit_obsgp1d(jnp.asarray(theta, jnp.float32),
                           jnp.asarray(f, jnp.float32),
                           jnp.asarray(valid), OBSGP_1D)
    m, v = obsgp.obsgp1d_test(st, jnp.asarray(q, jnp.float32), OBSGP_1D,
                              chunk=64)
    m, v = np.asarray(m), np.asarray(v)
    np.testing.assert_array_equal(v >= 1e5, v_ref >= 1e5)
    ok = v < 1e5
    np.testing.assert_allclose(m[ok], m_ref[ok], rtol=2e-3, atol=2e-3)


def test_obsgp1d_too_few_samples():
    # n < group_size -> nGroup == 1 -> nothing trained (ObsGP.cpp:91-139)
    n = 12
    theta = np.sort(RNG.uniform(-1, 1, n))
    st = obsgp.fit_obsgp1d(jnp.asarray(theta, jnp.float32),
                           jnp.ones(n, jnp.float32), jnp.ones(n, bool),
                           OBSGP_1D)
    m, v = obsgp.obsgp1d_test(st, jnp.asarray(theta, jnp.float32), OBSGP_1D,
                              chunk=16)
    assert np.all(np.asarray(v) >= 1e5)


def naive_obsgp2d(vc, uc, f, q, p):
    """Literal 2D partition + per-cell GPou (ObsGP.cpp:204-463)."""
    ni, nj = len(vc), len(uc)
    gs, ov = p.group_size, p.overlap
    ng0 = (ni - ov) // gs + 1
    ng1 = (nj - ov) // gs + 1
    val_i = [vc[0]] + [vc[g * gs + gs + ov - 1 - ov // 2]
                       if g < ng0 - 1 else vc[ni - 1] for g in range(ng0)]
    val_j = [uc[0]] + [uc[g * gs + gs + ov - 1 - ov // 2]
                       if g < ng1 - 1 else uc[nj - 1] for g in range(ng1)]
    cells = {}
    for a in range(ng0):
        i0, i1 = a * gs, (a * gs + gs + ov - 1) if a < ng0 - 1 else ni - 1
        for b in range(ng1):
            j0, j1 = b * gs, (b * gs + gs + ov - 1) if b < ng1 - 1 else nj - 1
            xs, fs = [], []
            for i in range(i0, i1 + 1):
                for j in range(j0, j1 + 1):
                    if f[i, j] > 0:
                        xs.append([vc[i], uc[j]])
                        fs.append(f[i, j])
            if xs:
                cells[(a, b)] = (np.array(xs), np.array(fs))
    mean = np.zeros(len(q))
    var = np.full(len(q), 1e6)
    for k, (v, u) in enumerate(q):
        if (v < val_i[0] + p.margin or v > val_i[-1] - p.margin
                or u < val_j[0] + p.margin or u > val_j[-1] - p.margin):
            continue
        a = 0
        for t in val_i[1:]:
            if v < t:
                break
            a += 1
        b = 0
        for t in val_j[1:]:
            if u < t:
                break
            b += 1
        a, b = min(a, ng0 - 1), min(b, ng1 - 1)
        if (a, b) in cells:
            xs, fs = cells[(a, b)]
            m_, v_ = gpou_fit_test(xs, fs, p.scale, p.noise,
                                   np.array([[v, u]]))
            mean[k], var[k] = m_[0], v_[0]
    return mean, var


def test_obsgp2d_matches_naive():
    ni, nj = 18, 23
    vc = np.linspace(-0.4, 0.4, ni)
    uc = np.linspace(-0.5, 0.5, nj)
    f = 1.0 + 0.2 * RNG.normal(size=(ni, nj))
    f[RNG.uniform(size=(ni, nj)) < 0.3] = -1.0   # invalid pixels
    q = np.stack([RNG.uniform(-0.45, 0.45, 300),
                  RNG.uniform(-0.55, 0.55, 300)], -1)

    m_ref, v_ref = naive_obsgp2d(vc, uc, f, q, OBSGP_2D)
    st = obsgp.fit_obsgp2d(jnp.asarray(vc, jnp.float32),
                           jnp.asarray(uc, jnp.float32),
                           jnp.asarray(f, jnp.float32), OBSGP_2D)
    m, v = obsgp.obsgp2d_test(st, jnp.asarray(q, jnp.float32), OBSGP_2D,
                              chunk=128)
    m, v = np.asarray(m), np.asarray(v)
    np.testing.assert_array_equal(v >= 1e5, v_ref >= 1e5)
    ok = v < 1e5
    np.testing.assert_allclose(m[ok], m_ref[ok], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(v[ok], v_ref[ok], rtol=2e-3, atol=2e-3)


def test_obsgp2d_blocked_matches_gather():
    """The cell-blocked evaluator (obsgp2d_test_blocked) must reproduce
    the gather path exactly on a REAL frame: same cell lookup, margins,
    sentinels; values to f32 matmul tolerance. Also verifies the roff=1
    coverage assumption: no valid pixel's probe hops more than one cell
    from its pixel's static owning cell."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpismap import datasets
    from gpismap.config import MAPPER_3D, OBSGP_2D, CameraParam
    from gpismap.models import mapper3d, obsgp

    fr = next(datasets.tabletop_frames(0, 1))
    from gpismap.config import BIGBIRD_CAMS
    cam = BIGBIRD_CAMS[fr.cam_id - 1]
    pose = np.asarray(fr.pose, np.float32).reshape(-1)
    tr, rot = pose[:3], pose[3:12].reshape(3, 3, order="F")

    prep = mapper3d.preprocess_3d(jnp.asarray(fr.depth, jnp.float32),
                                  jnp.asarray(tr), jnp.asarray(rot), cam,
                                  MAPPER_3D)
    obs = obsgp.fit_obsgp2d(prep.v, prep.u, prep.zinv, OBSGP_2D)

    nm_g = mapper3d.newmeas_3d(obs, prep, jnp.asarray(rot), MAPPER_3D,
                               OBSGP_2D, cam=cam, blocked=False)
    nm_b = mapper3d.newmeas_3d(obs, prep, jnp.asarray(rot), MAPPER_3D,
                               OBSGP_2D, cam=cam, blocked=True)

    np.testing.assert_array_equal(np.asarray(nm_g.insert_ok),
                                  np.asarray(nm_b.insert_ok))
    ok = np.asarray(nm_g.insert_ok)
    np.testing.assert_allclose(np.asarray(nm_g.pos)[ok],
                               np.asarray(nm_b.pos)[ok], rtol=1e-6,
                               atol=1e-6)
    # grad/noise come from finite differences of the posterior mean
    # (divided by delx = 1e-3), which amplifies f32 reduction-order
    # noise ~1000x; tolerance sized accordingly
    for name in ("grad", "noise", "grad_noise"):
        a = np.asarray(getattr(nm_g, name))[ok]
        b = np.asarray(getattr(nm_b, name))[ok]
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3,
                                   err_msg=name)
        assert np.median(np.abs(a - b)) < 1e-4, name

    # coverage: every valid pixel's probe lands within +-1 cell of the
    # pixel's static owning cell (the roff=1 guarantee)
    m, n = prep.valid.shape
    row_idx, col_idx = mapper3d._grid_ownership(cam, MAPPER_3D, OBSGP_2D)
    a_of_row = np.full(m, -1)
    for a, rows in enumerate(row_idx):
        a_of_row[rows[rows >= 0]] = a
    b_of_col = np.full(n, -1)
    for b, cols in enumerate(col_idx):
        b_of_col[cols[cols >= 0]] = b

    pert = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                       [0, 0, 1], [0, 0, -1]], np.float32) * MAPPER_3D.delx
    loc = np.asarray(prep.xyz_local)
    ppos = loc[:, :, None, :] + pert[None, None]
    pz = np.where(np.abs(ppos[..., 2]) > 1e-12, ppos[..., 2], 1e-12)
    pv = ppos[..., 1] / pz
    pu = ppos[..., 0] / pz
    val_i = np.asarray(obs.val_i)
    val_j = np.asarray(obs.val_j)
    ng0, ng1 = len(val_i) - 1, len(val_j) - 1
    a_true = np.clip((val_i[None, None, None, 1:]
                      <= pv[..., None]).sum(-1), 0, ng0 - 1)
    b_true = np.clip((val_j[None, None, None, 1:]
                      <= pu[..., None]).sum(-1), 0, ng1 - 1)
    valid = np.asarray(prep.valid)
    da = np.abs(a_true - a_of_row[:, None, None])[valid]
    db = np.abs(b_true - b_of_col[None, :, None])[valid]
    assert da.max() <= 1 and db.max() <= 1, (da.max(), db.max())


def test_newmeas3d_compact_matches_gather():
    """The compacted probe sweep (newmeas_3d nv_cap) must reproduce the
    gather path EXACTLY for every pixel that can insert: it routes the
    same queries through the same evaluator, only skipping pixels the
    range gate already excludes (whose outputs are sentinel-filled and
    unobservable through insert_ok)."""
    import jax.numpy as jnp
    import numpy as np

    from gpismap import datasets
    from gpismap.config import BIGBIRD_CAMS, MAPPER_3D, OBSGP_2D
    from gpismap.models import mapper3d, obsgp

    fr = next(datasets.tabletop_frames(0, 1))
    cam = BIGBIRD_CAMS[fr.cam_id - 1]
    pose = np.asarray(fr.pose, np.float32).reshape(-1)
    tr, rot = pose[:3], pose[3:12].reshape(3, 3, order="F")

    prep = mapper3d.preprocess_3d(jnp.asarray(fr.depth, jnp.float32),
                                  jnp.asarray(tr), jnp.asarray(rot), cam,
                                  MAPPER_3D)
    obs = obsgp.fit_obsgp2d(prep.v, prep.u, prep.zinv, OBSGP_2D)

    nv = int(np.asarray(prep.valid).sum())
    nv_cap = max(1024, 1 << (nv - 1).bit_length())
    nm_g = mapper3d.newmeas_3d(obs, prep, jnp.asarray(rot), MAPPER_3D,
                               OBSGP_2D, cam=cam, blocked=False)
    nm_c = mapper3d.newmeas_3d(obs, prep, jnp.asarray(rot), MAPPER_3D,
                               OBSGP_2D, cam=cam, nv_cap=nv_cap)

    np.testing.assert_array_equal(np.asarray(nm_g.insert_ok),
                                  np.asarray(nm_c.insert_ok))
    ok = np.asarray(nm_g.insert_ok)
    assert ok.sum() > 100          # a real frame exercises the path
    for name in ("pos", "grad", "noise", "grad_noise"):
        np.testing.assert_array_equal(
            np.asarray(getattr(nm_g, name))[ok],
            np.asarray(getattr(nm_c, name))[ok], err_msg=name)

    # a too-small cap must also stay silent-cap-free at the semantics
    # level: pixels beyond the cap are simply treated as gated out
    # (insert_ok False), never evaluated wrongly — verify the compacted
    # set is valid-first so a cap >= nv loses nothing
    assert nv <= nv_cap


def test_fit_obsgp2d_compacted_matches_full():
    """fit_obsgp2d(c_cap) must produce EXACTLY the full fit's alpha and
    L^-1 on every trained cell (each cell's masked system is independent,
    so compacting the Cholesky batch cannot change per-cell results),
    and the identical trained mask. Also checks the host nonempty-cell
    counter (api3d._obs_cell_cap's integral image) never undercounts."""
    import jax.numpy as jnp
    import numpy as np

    from gpismap import datasets
    from gpismap.config import BIGBIRD_CAMS, MAPPER_3D, OBSGP_2D
    from gpismap.models import mapper3d, obsgp

    fr = next(datasets.tabletop_frames(0, 1))
    cam = BIGBIRD_CAMS[fr.cam_id - 1]
    pose = np.asarray(fr.pose, np.float32).reshape(-1)
    prep = mapper3d.preprocess_3d(
        jnp.asarray(fr.depth, jnp.float32), jnp.asarray(pose[:3]),
        jnp.asarray(pose[3:12].reshape(3, 3, order="F")), cam, MAPPER_3D)

    full = obsgp.fit_obsgp2d(prep.v, prep.u, prep.zinv, OBSGP_2D)
    ntr = int(np.asarray(full.trained).sum())
    assert ntr > 50
    c_cap = max(256, 1 << (ntr - 1).bit_length())
    comp = obsgp.fit_obsgp2d(prep.v, prep.u, prep.zinv, OBSGP_2D,
                             c_cap=c_cap)

    tr = np.asarray(full.trained)
    np.testing.assert_array_equal(tr, np.asarray(comp.trained))
    np.testing.assert_array_equal(np.asarray(full.alpha)[tr],
                                  np.asarray(comp.alpha)[tr])
    np.testing.assert_array_equal(np.asarray(full.linv)[tr],
                                  np.asarray(comp.linv)[tr])

    # host cell counter covers the trained set
    from gpismap.api3d import GPisMap3D
    m = GPisMap3D()
    m.set_camera(cam)
    nv, _ = m._host_gate(fr.depth)
    import os
    os.environ["GPISMAP_OBS_COMPACT"] = "1"
    try:
        cap_host = m._obs_cell_cap(m._last_valid_mask)
    finally:
        del os.environ["GPISMAP_OBS_COMPACT"]
    assert cap_host >= ntr

    # end-to-end posteriors agree exactly at real query points
    vu = jnp.asarray(np.random.default_rng(0).uniform(-0.3, 0.3, (512, 2)),
                     jnp.float32)
    mf, vf = obsgp.obsgp2d_test(full, vu, OBSGP_2D)
    mc, vc = obsgp.obsgp2d_test(comp, vu, OBSGP_2D)
    np.testing.assert_array_equal(np.asarray(mf), np.asarray(mc))
    np.testing.assert_array_equal(np.asarray(vf), np.asarray(vc))
