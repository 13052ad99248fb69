"""The port's sharded solvers across real process boundaries: 2 local
processes x 2 virtual CPU shards each, joined by torch.distributed over
gloo through ``parallel.hostmesh.maybe_init_distributed``.  The workers
run tests/torch_multiprocess_worker.py (port only, no JAX).

Checked: the (process x local shard) host mesh and a psum over it; the
replicated outputs of the sharded BA (dense and cg, two-phase) and of the
sharded essential graph bit-identical on both ranks (every rank solves
the same all-reduced systems); and each within the stated tolerance of
the single-device solve each worker computes: BA rotations within 1e-5,
translations within 1e-4, points within 5e-4, the same edge inliers
(measured: dense 2.2e-6 / 1.7e-5 / 4.6e-5, cg 1.3e-6 / 2.0e-5 / 4.8e-5;
one fixed camera leaves the scale to the damping, and the sums run in
another order), the graph's poses within 2e-6 (measured: 0).  Each
worker has a 120 s timeout, so a hung collective fails the test.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

NPROC, LOCAL = 2, 2
BA_TOL = dict(dR=1e-5, dt=1e-4, dX=5e-4)
GRAPH_TOL = 2e-6


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mp") / "rank")
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_multiprocess_worker.py")
    env = dict(os.environ, ORB_SLAM_TPU_COORDINATOR=f"127.0.0.1:"
               f"{_free_port()}", ORB_SLAM_TPU_NUM_PROCS=str(NPROC),
               ORB_SLAM_TPU_TEST_LOCAL_SHARDS=str(LOCAL),
               ORB_SLAM_TPU_TEST_OUT=out, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, worker], env=dict(env, ORB_SLAM_TPU_PROC_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(NPROC)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker rc={p.returncode}\n{log[-4000:]}"
    recs = []
    for r in range(NPROC):
        with open(f"{out}.{r}") as f:
            recs.append(json.load(f))
    return recs


def test_host_mesh_across_processes(ranks):
    for r, rec in enumerate(ranks):
        assert rec["rank"] == r and rec["process_count"] == NPROC
        assert rec["local_devices"] == LOCAL
        assert rec["global_devices"] == NPROC * LOCAL
        # the model axis spans processes, the data axis a process's shards
        assert rec["mesh_shape"] == [NPROC, LOCAL]
        assert rec["own_shards"] == list(range(r * LOCAL, (r + 1) * LOCAL))
        assert rec["mesh_psum"] == sum(range(NPROC * LOCAL))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_sharded_ba_across_processes(ranks, solver):
    a, b = (rec[f"ba_{solver}"] for rec in ranks)
    for key in ("R", "t", "X", "inliers"):
        assert a[key] == b[key], key            # bit-identical on both ranks
    for key, tol in BA_TOL.items():
        assert a[key] <= tol, (key, a[key])
    assert a["inliers_equal"]


def test_sharded_graph_across_processes(ranks):
    a, b = (rec["graph"] for rec in ranks)
    for key in ("s", "R", "t"):
        assert a[key] == b[key], key
    for key in ("ds", "dR", "dt"):
        assert a[key] <= GRAPH_TOL, (key, a[key])
