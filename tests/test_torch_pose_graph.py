"""The essential-graph optimizer and the landmark correction on the CPU: the
port against the JAX package on the same graphs.

The graph is the drifted 12-keyframe ring of
tests/test_sim3_and_posegraph.py::test_pose_graph_closes_loop (odometry
edges with ground-truth measurements, one loop edge, keyframe 0 fixed),
built once with the JAX package's algebra and handed to both packages.
The repeated- and invalid-edge cases use its odometry chain plus one edge
(12 edges, as the ring), so the JAX package compiles one program.

Tolerances, and the gaps they were set from (measured on this CPU):
  - per-iteration costs: the first (before any step) within rtol 2e-6,
    every one within COST_TOL 2e-6 times the first.  Measured: first costs
    0 (the ring) and 3.6e-7 (the chains started 0.03 off the truth: float32
    sums of squares in another order); every cost within 8e-9 (the ring)
    and 3.8e-7 (the chains) of the first.  The cost after a step is the
    small remainder of a ~1000x drop, so its gap scales with the first
    cost, not with itself; from iteration 3 on both packages sit at
    float32 noise (~1e-13);
  - final poses: POSE_TOL 1e-5 on s, R and t (measured <= 3.0e-7);
  - correct_points: 1e-5 against JAX (measured <= 4.8e-7) and the JAX
    test's 1e-4 on S_new(X') = S_old(X).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam_tpu.geometry import sim3 as jsim3
from orb_slam_tpu.solvers import pose_graph as jpg
from orb_slam_tpu_torch.geometry import sim3 as tsim3
from orb_slam_tpu_torch.solvers import pose_graph as tpg
from test_sim3_and_posegraph import _ring_poses
from torch_port_util import np_of, t_of

N_KF = 12
N_ITERS = 20
COST_TOL = 2e-6
POSE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The problems are tiny: torch's intra-op threads only add overhead
    (3x per graph iteration on this CPU) and oversubscribe the cores under
    the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _measure(g_gt, a, b):
    """Shat_ab = S_a o S_b^-1 from ground-truth poses."""
    s, R, t = g_gt
    return jsim3.compose(s[a], R[a], t[a], *jsim3.inverse(s[b], R[b], t[b]))


def _edges(g_gt, pairs, valid=None):
    """numpy edge arrays for `pairs` with ground-truth measurements."""
    ms = [_measure(g_gt, a, b) for a, b in pairs]
    return dict(i=np.array([a for a, _ in pairs], np.int32),
                j=np.array([b for _, b in pairs], np.int32),
                s_meas=np.stack([np.asarray(m[0]) for m in ms]),
                R_meas=np.stack([np.asarray(m[1]) for m in ms]),
                t_meas=np.stack([np.asarray(m[2]) for m in ms]),
                valid=np.ones(len(pairs), bool) if valid is None else valid)


def solve_both(ring, edges, n_iters=N_ITERS):
    start = ring["start"]
    fixed = np.arange(N_KF) == 0
    out_j = jpg.optimize_essential_graph(
        *[jnp.asarray(a) for a in start], jnp.asarray(fixed),
        jpg.Sim3Edges(**{k: jnp.asarray(v) for k, v in edges.items()}),
        n_iters=n_iters)
    out_t = tpg.optimize_essential_graph(
        *[t_of(a) for a in start], t_of(fixed),
        tpg.Sim3Edges(**{k: t_of(v) for k, v in edges.items()}),
        n_iters=n_iters)
    return [np_of(x) for x in out_t], [np_of(x) for x in out_j]


def assert_same(out_t, out_j):
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a, b, atol=POSE_TOL, rtol=0)
    cj = out_j[3]
    np.testing.assert_allclose(out_t[3][0], cj[0], rtol=2e-6)
    np.testing.assert_allclose(out_t[3], cj, rtol=0, atol=COST_TOL * cj[0])


@pytest.fixture(scope="module")
def ring():
    """The drifted ring of test_pose_graph_closes_loop, its edges, and the
    JAX package's solution of it."""
    s_gt, R_gt, t_gt, rel = _ring_poses(N_KF)
    rng = np.random.default_rng(3)
    s, R, t = [s_gt[0]], [R_gt[0]], [t_gt[0]]
    for k in range(1, N_KF):
        noise = jsim3.exp(jnp.asarray(rng.normal(0, 0.02, 7)))
        step = jsim3.compose(*noise, *rel[k - 1])
        sk, Rk, tk = jsim3.compose(*step, s[-1], R[-1], t[-1])
        s.append(sk); R.append(Rk); t.append(tk)
    g_gt = (s_gt, R_gt, t_gt)
    pairs = [(k, k - 1) for k in range(1, N_KF)] + [(N_KF - 1, 0)]
    ring = dict(g_gt=[np.asarray(x) for x in g_gt],
                start=[np.asarray(jnp.stack(x)) for x in (s, R, t)])
    ring["edges"] = _edges(g_gt, pairs)
    ring["out_t"], ring["out_j"] = solve_both(ring, ring["edges"])
    return ring


def _err(t, t_gt):
    return float(np.linalg.norm(t - t_gt, axis=1).sum())


def test_pose_graph_closes_loop(ring):
    """Costs per iteration and final poses as JAX's; the drift is spread:
    the translation error to ground truth drops below 0.25x its start."""
    out_t, out_j = ring["out_t"], ring["out_j"]
    assert_same(out_t, out_j)
    assert out_t[3].shape == (N_ITERS,) and np.isfinite(out_t[3]).all()
    e0 = _err(ring["start"][2], ring["g_gt"][2])
    e1 = _err(out_t[2], ring["g_gt"][2])
    assert e1 < 0.25 * e0, f"pose error {e0} -> {e1}"


def test_fixed_vertex_does_not_move(ring):
    for got, start in zip(ring["out_t"][:3], ring["start"]):
        np.testing.assert_array_equal(got[0], start[0])


@pytest.fixture(scope="module")
def chain(ring):
    """The ring's keyframes started off the ground truth in every free
    vertex, with the 11 odometry edges (no loop edge).  With one more edge
    the graph has the ring's 12 edges, so JAX reuses the ring's compile."""
    rng = np.random.default_rng(5)
    noise = jsim3.exp(jnp.asarray(rng.normal(0, 0.03, (N_KF, 7)),
                                  jnp.float32))
    start = jsim3.compose(*noise, *[jnp.asarray(x) for x in ring["g_gt"]])
    pairs = [(k, k - 1) for k in range(1, N_KF)]
    return dict(start=[np.asarray(x) for x in start], pairs=pairs,
                g_gt=ring["g_gt"])


def _port_alone(chain, edges):
    return [np_of(x) for x in tpg.optimize_essential_graph(
        *[t_of(a) for a in chain["start"]], t_of(np.arange(N_KF) == 0),
        tpg.Sim3Edges(**{k: t_of(v) for k, v in edges.items()}),
        n_iters=N_ITERS)]


def test_repeated_edge_accumulates(chain):
    """A second edge on the same (i, j) accumulates into H and b as the JAX
    package's .at[].add: the same costs and poses as JAX, and a first cost
    that is the single-edge graph's plus the duplicate's own squared
    residual."""
    edges = _edges(chain["g_gt"], chain["pairs"] + [(5, 4)])
    out_t, out_j = solve_both(chain, edges)
    assert_same(out_t, out_j)
    single = _port_alone(chain, {k: v[:-1] for k, v in edges.items()})
    st = [t_of(a) for a in chain["start"]]
    r = tpg._edge_residual(*[x[5] for x in st], *[x[4] for x in st],
                           *[t_of(edges[k][-1]) for k in
                             ("s_meas", "R_meas", "t_meas")])
    np.testing.assert_allclose(out_t[3][0],
                               single[3][0] + float(torch.sum(r * r)),
                               rtol=1e-6)
    assert not np.array_equal(out_t[2], single[2])


def test_invalid_edge_contributes_nothing(chain):
    """An edge with valid=False whose measurement is far off (were it
    counted, it would pull keyframes 2 and 6): the same costs and poses as
    JAX, and the port's poses without it are the same to the bit."""
    valid = np.ones(N_KF, bool)
    valid[-1] = False
    edges = _edges(chain["g_gt"], chain["pairs"] + [(6, 2)], valid)
    edges["t_meas"][-1] += 3.0
    out_t, out_j = solve_both(chain, edges)
    assert_same(out_t, out_j)
    kept = _port_alone(chain, {k: v[:-1] for k, v in edges.items()})
    for a, b in zip(out_t[:3], kept[:3]):
        np.testing.assert_array_equal(a, b)
    # the cost sums one more (zero) term, which may round the last bit
    # apart (measured: 1 ulp at 1.6e-13)
    np.testing.assert_allclose(out_t[3], kept[3], rtol=1e-6)


def test_correct_points():
    """Points re-mapped through their corrected reference keyframe keep
    their camera-frame coordinates: S_new(X') == S_old(X); and X' is the
    JAX package's."""
    rng = np.random.default_rng(1)
    P = rng.normal(0, 2, (50, 3)).astype(np.float32)
    K = 4
    s_old = np.ones(K, np.float32)
    R_old = np.stack([np.eye(3, dtype=np.float32)] * K)
    t_old = rng.normal(0, 1, (K, 3)).astype(np.float32)
    zeta = rng.normal(0, 0.2, (K, 7)).astype(np.float32)
    new = [np_of(x) for x in tsim3.exp(t_of(zeta))]
    ref = rng.integers(0, K, 50).astype(np.int32)
    old = (s_old, R_old, t_old)
    P2 = tpg.correct_points(t_of(P), t_of(ref), *[t_of(x) for x in old],
                            *[t_of(x) for x in new])
    P2j = jpg.correct_points(jnp.asarray(P), jnp.asarray(ref),
                             *[jnp.asarray(x) for x in old],
                             *[jnp.asarray(x) for x in new])
    np.testing.assert_allclose(np_of(P2), np_of(P2j), atol=1e-5, rtol=0)
    Xc_old = tsim3.transform(*[t_of(x[ref]) for x in old], t_of(P))
    Xc_new = tsim3.transform(*[t_of(x[ref]) for x in new], P2)
    np.testing.assert_allclose(np_of(Xc_new), np_of(Xc_old), atol=1e-4)
