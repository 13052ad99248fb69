"""Micro-batched tracking on the CPU: the port's frame_step_scan against
the JAX package's (use_pallas=False), and against B chained calls of the
port's own frame_step; and the port's entry() twin.

B = 3 rows of a rendered 320x240 world (``smoke_world``, the map built from
the JAX package's keypoints, as in test_torch_frame_step.py); the last row
is the padding of a partial flush (a copy of the row before, row_valid
False).  Tolerances, as test_torch_frame_step.py: keypoints identical;
descriptors within 2 bits (>= 99% identical); poses within 1e-4;
pid_global equal on >= 98% of slots; and here the landmark counts after
the batch exact, the padded row adding nothing to them.  The port's scan
equals B chained calls of its own frame_step exactly (the same per-frame
body).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
import smoke_world as syn
from orb_slam_tpu import config as jc
from orb_slam_tpu.frontend import extractor_batched as jeb
from orb_slam_tpu.geometry import camera as jcam
from orb_slam_tpu.pipeline import frame_step as jfs
from orb_slam_tpu_torch import config as tc, entry as tentry, state as tst
from orb_slam_tpu_torch.pipeline import frame_step as tfs
from torch_port_util import desc_bits, np_of

W, H = 320, 240
CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, k1=0.0, k2=0.0, p1=0.0,
           p2=0.0, k3=0.0, width=W, height=H)
EXT = dict(n_features=500, max_keypoints=512)
MAP_VIEWS, ROWS = (0, 3, 6), (7, 8, 8)      # the last row pads the batch
ROW_VALID = np.array([True, True, False])
SEED = 7
STACKED = ("xy", "xy_und", "response", "angle", "level", "desc", "kp_valid",
           "inv_sigma2", "sigma2", "R", "t", "host_blob")
CHAIN = ("last_desc", "last_level", "last_angle", "next_last_pos",
         "next_last_valid", "R_last", "t_last", "R_prev", "t_prev",
         "lm_matches")


@pytest.fixture(scope="module")
def world():
    jcfg = jc.SystemConfig(camera=jc.CameraConfig(**CAM),
                           extractor=jc.ExtractorConfig(**EXT))
    tcfg = tc.SystemConfig(camera=tc.CameraConfig(**CAM),
                           extractor=tc.ExtractorConfig(**EXT))
    renderer, arrays = syn.tracking_world(
        lambda img: jeb.extract_batched(
            jnp.asarray(img), jcfg.extractor, EXT["n_features"],
            EXT["max_keypoints"], False),
        jcfg.camera.K, MAP_VIEWS, window=2048, pool=4096, width=W, height=H,
        seed=SEED)
    images = np.stack([renderer.render(*syn.pose_at(i)) for i in ROWS])
    jcamp = jcam.make_camera(jcfg.camera)
    tcamp = tst.camera_from_numpy(
        {k: np_of(getattr(jcamp, k)) for k in jcamp._fields}, device="cpu")
    kw = dict(ext_cfg=tcfg.extractor, matcher_cfg=tcfg.matcher,
              solver_cfg=tcfg.solver)
    ts = tst.state_from_numpy(arrays, device="cpu")
    tout = tfs.frame_step_scan(images, ROW_VALID, *ts, True, tcamp, **kw,
                               device="cpu")
    return dict(jcfg=jcfg, arrays=arrays, images=images, jcamp=jcamp,
                tcamp=tcamp, kw=kw, tout=tout)


def test_scan_matches_jax(world):
    ints = ("sel", "last_level", "prev_lm_matches")
    js = {k: jnp.asarray(np.asarray(v, np.int32) if k in ints else v)
          for k, v in world["arrays"].items()}
    jcfg = world["jcfg"]
    jo = jfs.frame_step_scan(
        jnp.asarray(world["images"]), jnp.asarray(ROW_VALID),
        *[js[n] for n in tst.FrameState._fields], jnp.bool_(True),
        world["jcamp"], ext_cfg=jcfg.extractor, matcher_cfg=jcfg.matcher,
        solver_cfg=jcfg.solver, use_pallas=False)
    to = world["tout"]
    for b in range(len(ROWS)):
        v = np_of(jo.kp_valid[b])
        np.testing.assert_array_equal(np_of(to.kp_valid[b]), v)
        np.testing.assert_array_equal(np_of(to.level[b]), np_of(jo.level[b]))
        np.testing.assert_array_equal(np_of(to.xy[b]), np_of(jo.xy[b]))
        bits = desc_bits(np_of(to.desc[b])[v], np_of(jo.desc[b])[v])
        assert bits.max() <= 2 and (bits == 0).mean() >= 0.99
        jb, tb = np_of(jo.host_blob[b]), np_of(to.host_blob[b])
        np.testing.assert_allclose(tb[:12], jb[:12], atol=1e-4)
        assert (tb[16:] == jb[16:]).mean() >= 0.98
        assert tb[15] >= 100, "the frame must track"
    np.testing.assert_array_equal(np_of(to.mp_visible), np_of(jo.mp_visible))
    np.testing.assert_array_equal(np_of(to.mp_found), np_of(jo.mp_found))
    assert int(to.lm_matches) == int(jo.lm_matches)


def test_scan_is_chained_frame_steps(world):
    """Row b of the scan is the b-th of chained frame_step calls, exactly;
    the padded row leaves the counts as the valid rows left them."""
    ts = tst.state_from_numpy(world["arrays"], device="cpu")
    to = world["tout"]
    counts = None
    for b, img in enumerate(world["images"]):
        out = tfs.frame_step(img, *ts, world["tcamp"], **world["kw"],
                             device="cpu")
        for name in STACKED:
            assert torch.equal(getattr(to, name)[b], getattr(out, name)), \
                (b, name)
        if ROW_VALID[b]:
            counts = (out.mp_visible, out.mp_found)
        prev = ts
        ts = tst.chain(ts, out)
    assert torch.equal(to.mp_visible, counts[0])
    assert torch.equal(to.mp_found, counts[1])
    assert not torch.equal(ts.mp_visible, counts[0]), \
        "the padded row would have counted"
    last = dict(last_desc=out.desc, last_level=out.level,
                last_angle=out.angle, next_last_pos=out.next_last_pos,
                next_last_valid=out.next_last_valid, R_last=out.R,
                t_last=out.t, R_prev=prev.R_last, t_prev=prev.t_last,
                lm_matches=out.lm_matches)
    for name in CHAIN:
        assert torch.equal(getattr(to, name), last[name]), name
    # slice_frame takes one row out of the stacked fields
    row = tfs.slice_frame((to.xy, to.desc), 1)
    assert torch.equal(row[0], to.xy[1]) and torch.equal(row[1], to.desc[1])


def test_entry_twin_matches_graft_entry():
    """orb_slam_tpu_torch.entry against __graft_entry__.entry: the same
    inputs exactly, the pose within 1e-5 and the inlier count equal."""
    jfn, jargs = ge.entry()
    tfn, targs = tentry.entry(device="cpu")
    assert len(jargs) == len(targs)
    for a, b in zip(jargs, targs):
        a, b = np_of(a), np_of(b)
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        np.testing.assert_array_equal(b, a.astype(b.dtype))
    R_j, t_j, n_j = jfn(*jargs)
    R_t, t_t, n_t = tfn(*targs)
    np.testing.assert_allclose(np_of(R_t), np_of(R_j), atol=1e-5)
    np.testing.assert_allclose(np_of(t_t), np_of(t_j), atol=1e-5)
    assert int(n_t) == int(n_j) > 400
