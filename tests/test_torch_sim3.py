"""The Sim(3) algebra, the Sim3 RANSAC and the Sim3 refinement on the CPU:
the port against the JAX package on the same numpy-seeded inputs, with the
JAX package's RANSAC draws injected.

Tolerances, and the gaps they were set from (measured on this CPU):
  - ALG_TOL 1e-5 on exp / log / compose / inverse / retract outputs and on
    exp's forward-mode Jacobian at the Taylor branches: measured <= 2.1e-7
    (float32 transcendental functions of two libraries);
  - the mirrored cases of tests/test_sim3.py keep that file's bounds on the
    port alone (1e-4 round trip, 1e-5 / 1e-6 elsewhere);
  - umeyama on an exact 30-point set: the ground truth within the JAX
    test's 1e-4; against JAX within FIT_TOL 1e-5 (measured <= 3.0e-7);
  - sim3_ransac with JAX's draws: the inlier mask, ok and the count
    exactly; s / R / t within FIT_TOL (measured <= 5.4e-7, and 2.9e-6 on t
    with fix_scale: one polish on the same inlier set).  A single 3-point
    hypothesis can sit 1.5e-5 (R) and 6.7e-5 (t, relative) from JAX's when
    its points are nearly collinear, so hypotheses are compared only
    through the winner;
  - optimize_sim3: the same inlier mask and count; s / R / t within
    FIT_TOL (measured <= 1.2e-7 after 15 Gauss-Newton steps).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam_tpu.geometry import sim3 as jsim3
from orb_slam_tpu.solvers import sim3_opt as jopt
from orb_slam_tpu.solvers import sim3_solver as jsolver
from orb_slam_tpu_torch.geometry import se3 as tse3
from orb_slam_tpu_torch.geometry import sim3 as tsim3
from orb_slam_tpu_torch.solvers import pnp as tpnp
from orb_slam_tpu_torch.solvers import sim3_opt as topt
from orb_slam_tpu_torch.solvers import sim3_solver as tsolver
from synthetic import default_K
from test_sim3_opt import make_pair
from torch_port_util import jax_draws, np_of, t_of

ALG_TOL = 1e-5
FIT_TOL = 1e-5
N_PAIRS = 120          # every refinement case: one JAX compile per fix_scale


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The problems are tiny: torch's intra-op threads only add overhead
    (3x per graph iteration on this CPU) and oversubscribe the cores under
    the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(port, ref, atol):
    for a, b in zip(port, ref):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=atol, rtol=0)


def rot_deg(Ra, Rb):
    dR = np_of(Ra) @ np_of(Rb).T
    return np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))


# --- the algebra (tests/test_sim3.py) ---------------------------------

def test_exp_log_roundtrip(rng):
    zeta = (rng.normal(size=(32, 7)) * 0.4).astype(np.float32)
    g = tsim3.exp(t_of(zeta))
    close(g, jsim3.exp(jnp.asarray(zeta)), ALG_TOL)
    z2 = tsim3.log(*g)
    close([z2], [jsim3.log(*jsim3.exp(jnp.asarray(zeta)))], ALG_TOL)
    np.testing.assert_allclose(np_of(z2), zeta, atol=1e-4)


def test_exp_zero_is_identity():
    s, R, t = tsim3.exp(torch.zeros(7))
    s0, R0, t0 = tsim3.identity()
    assert torch.equal(s, s0) and torch.equal(R, R0) and torch.equal(t, t0)


def test_compose_inverse(rng):
    z = (rng.normal(size=(16, 7)) * 0.3).astype(np.float32)
    g = tsim3.exp(t_of(z))
    gi = tsim3.inverse(*g)
    close(gi, jsim3.inverse(*jsim3.exp(jnp.asarray(z))), ALG_TOL)
    se_, Re, te = tsim3.compose(*g, *gi)
    np.testing.assert_allclose(np_of(se_), 1.0, atol=1e-5)
    np.testing.assert_allclose(np_of(Re), np.tile(np.eye(3), (16, 1, 1)),
                               atol=1e-5)
    np.testing.assert_allclose(np_of(te), 0.0, atol=1e-5)


def test_action_consistency(rng):
    """exp(zeta) applied to x == exp(zeta/2) o exp(zeta/2) applied to x."""
    zeta = (rng.normal(size=(7,)) * 0.5).astype(np.float32)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    y = tsim3.transform(*tsim3.exp(t_of(zeta)), t_of(x))
    gh = tsim3.exp(t_of(zeta * 0.5))
    y2 = tsim3.transform(*tsim3.compose(*gh, *gh), t_of(x))
    np.testing.assert_allclose(np_of(y), np_of(y2), atol=1e-4)
    yj = jsim3.transform(*jsim3.exp(jnp.asarray(zeta)), jnp.asarray(x))
    close([y], [yj], ALG_TOL)


def test_sigma_only():
    s, R, t = tsim3.exp(torch.zeros(7).index_fill(0, torch.tensor([6]), 0.7))
    np.testing.assert_allclose(float(s), np.exp(0.7), atol=1e-5)
    np.testing.assert_allclose(np_of(R), np.eye(3), atol=1e-6)
    np.testing.assert_allclose(np_of(t), 0.0, atol=1e-6)


def test_se3_embedding(rng):
    """exp of (xi, 0) is the SE(3) exponential; from_se3 / to_se3 /
    retract / identity as in the JAX package."""
    xi = (rng.normal(size=(6,)) * 0.3).astype(np.float32)
    R, t = tse3.exp(t_of(xi))
    s2, R2, t2 = tsim3.exp(torch.cat([t_of(xi), torch.zeros(1)]))
    np.testing.assert_allclose(float(s2), 1.0, atol=1e-6)
    np.testing.assert_allclose(np_of(R2), np_of(R), atol=1e-5)
    np.testing.assert_allclose(np_of(t2), np_of(t), atol=1e-5)

    Rb = np.stack([np_of(tse3.exp(t_of(x))[0]) for x in
                   (rng.normal(size=(4, 6)) * 0.3).astype(np.float32)])
    tb = rng.normal(size=(4, 3)).astype(np.float32)
    close(tsim3.from_se3(t_of(Rb), t_of(tb)),
          jsim3.from_se3(jnp.asarray(Rb), jnp.asarray(tb)), 0)
    g = tsim3.exp(t_of((rng.normal(size=(4, 7)) * 0.3).astype(np.float32)))
    close(tsim3.to_se3(*g), jsim3.to_se3(*[jnp.asarray(np_of(x))
                                           for x in g]), ALG_TOL)
    dz = (rng.normal(size=(4, 7)) * 0.1).astype(np.float32)
    close(tsim3.retract(*g, t_of(dz)),
          jsim3.retract(*[jnp.asarray(np_of(x)) for x in g],
                        jnp.asarray(dz)), ALG_TOL)
    close(tsim3.identity(), jsim3.identity(), 0)


def _branch_zetas(rng):
    """4 tangents in each of exp's coefficient branches: general, sigma ~ 0
    (|sigma| < 1e-5), theta ~ 0 (theta^2 < 1e-10) and both, each branch
    with exact zeros and with values just inside its threshold."""
    z = (rng.normal(size=(16, 7)) * 0.4).astype(np.float32)
    z[4:6, 6] = 0.0
    z[6:8, 6] = 3e-6
    z[8:10, 3:6] = 0.0
    z[10:12, 3:6] = 2e-6
    z[12:14, 3:7] = 0.0
    z[14:16, 3:6] = 2e-6
    z[14:16, 6] = -3e-6
    return z


def test_exp_log_at_taylor_branches(rng):
    """exp, log and exp's forward-mode Jacobian at each branch, batched,
    against the JAX package; every value and tangent finite (no NaN of an
    unselected branch leaks)."""
    z = _branch_zetas(rng)
    g = tsim3.exp(t_of(z))
    jg = jsim3.exp(jnp.asarray(z))
    close(g, jg, ALG_TOL)
    close([tsim3.log(*g)], [jsim3.log(*jg)], ALG_TOL)
    np.testing.assert_allclose(np_of(tsim3.log(*g)), z, atol=1e-4)

    def flat_t(zz):
        s, R, t = tsim3.exp(zz[None])
        return torch.cat([s, R.reshape(-1), t.reshape(-1)])

    def flat_j(zz):
        s, R, t = jsim3.exp(zz)
        return jnp.concatenate([s[None], R.reshape(-1), t])

    J = torch.stack([torch.func.jacfwd(flat_t)(t_of(zz)) for zz in z])
    Jj = jax.vmap(jax.jacfwd(flat_j))(jnp.asarray(z))
    assert torch.isfinite(J).all()
    close([J], [Jj], ALG_TOL)


# --- umeyama and the RANSAC (tests/test_sim3_and_posegraph.py) --------

def test_umeyama_sim3_exact(rng):
    P2 = rng.normal(0, 2, (30, 3)).astype(np.float32)
    zeta = rng.normal(0, 0.4, 7).astype(np.float32)
    g_gt = jsim3.exp(jnp.asarray(zeta))
    P1 = np.asarray(jsim3.transform(*g_gt, jnp.asarray(P2)))
    fit = tsolver.umeyama_sim3(t_of(P2), t_of(P1))
    np.testing.assert_allclose(float(fit[0]), float(g_gt[0]), rtol=1e-4)
    close(fit[1:], g_gt[1:], 1e-4)
    close(fit, jsolver.umeyama_sim3(jnp.asarray(P2), jnp.asarray(P1)),
          FIT_TOL)


def outlier_scene(rng, zeta, n=120):
    """The scene of test_sim3_ransac_with_outliers: n landmarks in front of
    KF2, their KF1 coordinates through zeta's Sim3, 0.3 px pixel noise, and
    30% of the X2 side displaced by 1-3 units (wrong associations)."""
    X2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 8, n)], 1).astype(np.float32)
    g = jsim3.exp(jnp.asarray(zeta, jnp.float32))
    X1 = np.asarray(jsim3.transform(*g, jnp.asarray(X2)))

    def project(X):
        return np.stack([500 * X[:, 0] / X[:, 2] + 320,
                         500 * X[:, 1] / X[:, 2] + 240], 1)

    uv1 = (project(X1) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    uv2 = (project(X2) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    k = int(0.3 * n)
    out = rng.choice(n, k, replace=False)
    X2[out] += rng.uniform(1, 3, (k, 3)).astype(np.float32)
    is_out = np.zeros(n, bool)
    is_out[out] = True
    args = [X1, X2, uv1, uv2, np.full(n, 9.21, np.float32),
            np.full(n, 9.21, np.float32), np.ones(n, bool), default_K()]
    return dict(args=args, g=g, is_out=is_out)


def run_both(args, samples, key, **kw):
    res_j = jsolver.sim3_ransac(key, *[jnp.asarray(a) for a in args], **kw)
    res_t = tsolver.sim3_ransac(*[t_of(a) for a in args],
                                samples=t_of(samples), **kw)
    return res_t, res_j


def assert_same_result(res_t, res_j):
    assert bool(res_t.ok) == bool(res_j.ok)
    assert int(res_t.n_inliers) == int(res_j.n_inliers)
    np.testing.assert_array_equal(np_of(res_t.inliers), np_of(res_j.inliers))
    close([res_t.s, res_t.R, res_t.t], [res_j.s, res_j.R, res_j.t], FIT_TOL)


@pytest.fixture(scope="module")
def ransac_scene():
    scene = outlier_scene(np.random.default_rng(42),
                          [0.2, -0.1, 0.3, 0.03, -0.05, 0.02, 0.1])
    scene["key"] = jax.random.PRNGKey(0)
    scene["samples"] = jax_draws(scene["key"], scene["args"][6], 256)
    return scene


def test_sim3_ransac_with_outliers(ransac_scene):
    sc = ransac_scene
    res_t, res_j = run_both(sc["args"], sc["samples"], sc["key"])
    assert_same_result(res_t, res_j)
    assert bool(res_t.ok)
    np.testing.assert_allclose(float(res_t.s), float(sc["g"][0]), rtol=0.02)
    assert rot_deg(res_t.R, sc["g"][1]) < 0.5
    assert np_of(res_t.inliers)[sc["is_out"]].mean() < 0.1


def test_sim3_ransac_degenerate_samples(ransac_scene):
    """A collinear minimal set and one holding a non-finite point: the
    collinear hypothesis is finite or NaN, the non-finite one NaN with no
    inlier, neither wins although both come first (argmax keeps the first
    maximum), and the result is JAX's."""
    sc = ransac_scene
    args = [a.copy() for a in sc["args"]]
    X1, X2 = args[0], args[1]
    inl = ~sc["is_out"]
    a, b, c, d = np.flatnonzero(inl)[:4]
    X2[c] = X2[a] + 0.5 * (X2[b] - X2[a])      # c on the line through a, b
    X1[c] = np.asarray(jsim3.transform(*sc["g"], jnp.asarray(X2[c])))
    X2[d] = np.nan                             # a valid row, not finite
    samples = np.concatenate([[[a, b, c], [a, b, d]], sc["samples"][2:]])
    res_t, res_j = run_both(args, samples, sc["key"])
    assert_same_result(res_t, res_j)
    assert rot_deg(res_t.R, sc["g"][1]) < 0.5

    s, R, t = tsolver.umeyama_sim3(t_of(X2[samples[:2]]),
                                   t_of(X1[samples[:2]]))
    hyp = torch.cat([s[:, None], R.reshape(2, -1), t], dim=1)
    assert torch.isfinite(hyp[0]).all() or torch.isnan(hyp[0]).all()
    assert torch.isnan(hyp[1]).all()
    for k in (0, 1):
        alone = tsolver.sim3_ransac(*[t_of(x) for x in args],
                                    samples=t_of(samples[k:k + 1]))
        assert int(alone.n_inliers) < int(res_t.n_inliers)
    assert int(tsolver.sim3_ransac(*[t_of(x) for x in args],
                                   samples=t_of(samples[1:2])).n_inliers) \
        == 0


def test_sim3_ransac_fix_scale():
    """fix_scale on a scale-1 scene: s is exactly 1, the rest JAX's."""
    sc = outlier_scene(np.random.default_rng(7),
                       [0.2, -0.1, 0.3, 0.03, -0.05, 0.02, 0.0])
    key = jax.random.PRNGKey(1)
    samples = jax_draws(key, sc["args"][6], 256)
    res_t, res_j = run_both(sc["args"], samples, key, fix_scale=True)
    assert_same_result(res_t, res_j)
    assert float(res_t.s) == 1.0
    assert bool(res_t.ok) and rot_deg(res_t.R, sc["g"][1]) < 0.5


def test_draw_samples_min_set_3():
    """The port's own draws: 3 distinct valid rows per sample."""
    valid = np.zeros(50, bool)
    valid[np.random.default_rng(3).choice(50, 12, replace=False)] = True
    gen = torch.Generator().manual_seed(5)
    samples = tpnp.draw_samples(gen, valid, 512, 3).numpy()
    assert samples.shape == (512, 3)
    assert valid[samples].all()
    srt = np.sort(samples, axis=1)
    assert (np.diff(srt, axis=1) > 0).all()
    # every valid row is drawn: the draw is over the whole valid set
    assert set(np.unique(samples)) == set(np.flatnonzero(valid))


# --- the refinement (tests/test_sim3_opt.py) ---------------------------

def refine_both(s0, R0, t0, p, X2=None, fix_scale=False):
    n = p["X1"].shape[0]
    X2 = p["X2"] if X2 is None else jnp.asarray(X2)
    args = [p["X1"], X2, p["uv1"], p["uv2"], jnp.ones(n), jnp.ones(n),
            jnp.ones(n, bool), jnp.asarray(p["K"])]
    res_j = jopt.optimize_sim3(s0, R0, t0, *args, fix_scale=fix_scale)
    res_t = topt.optimize_sim3(t_of(s0), t_of(R0), t_of(t0),
                               *[t_of(a) for a in args], fix_scale=fix_scale)
    assert int(res_t.n_inliers) == int(res_j.n_inliers)
    np.testing.assert_array_equal(np_of(res_t.inliers), np_of(res_j.inliers))
    close([res_t.s, res_t.R, res_t.t], [res_j.s, res_j.R, res_j.t], FIT_TOL)
    return res_t


def test_refines_perturbed_sim3(rng):
    p = make_pair(rng, n=N_PAIRS)
    dz = jnp.asarray(rng.normal(0, 0.02, 7).astype(np.float32))
    res = refine_both(*jsim3.retract(p["s"], p["R"], p["t"], dz), p)
    assert int(res.n_inliers) > 0.9 * N_PAIRS
    np.testing.assert_allclose(float(res.s), float(p["s"]), rtol=0.01)
    assert rot_deg(res.R, p["R"]) < 0.2


def test_gates_outliers(rng):
    """Mild residual outliers are gated without dragging the estimate."""
    p = make_pair(rng, n=N_PAIRS)
    X2 = np.asarray(p["X2"]).copy()
    out = rng.choice(N_PAIRS, 18, replace=False)
    X2[out] += (rng.uniform(0.08, 0.25, (18, 3))
                * rng.choice([-1, 1], (18, 3))).astype(np.float32)
    dz = jnp.asarray(rng.normal(0, 0.01, 7).astype(np.float32))
    res = refine_both(*jsim3.retract(p["s"], p["R"], p["t"], dz), p, X2)
    inl = np_of(res.inliers)
    assert inl[out].mean() < 0.35
    assert inl[np.setdiff1d(np.arange(N_PAIRS), out)].mean() > 0.85
    np.testing.assert_allclose(float(res.s), float(p["s"]), rtol=0.02)


def test_fix_scale_mode(rng):
    p = make_pair(rng, n=N_PAIRS, zeta_scale=0.1)
    res = refine_both(jnp.ones(()), p["R"], p["t"], p, fix_scale=True)
    assert float(res.s) == 1.0
