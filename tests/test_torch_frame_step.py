"""The slice as a whole: the port's frame_step (CPU) vs the JAX package's
frame_step (use_pallas=False) on three chained frames of a rendered world,
from the same numpy state; and tracking_megastep alone on identical numpy
features.

Tolerances: keypoint fields as in test_torch_extract.py; pid_global equal on
>= 98% of slots; the two poses within 1e-4 of each other (different float32
summation orders in the LM normal equations); the four host-blob stats
within +-2.  tracking_megastep alone: integer outputs exact, pose 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
import bench
import smoke_world as syn
from orb_slam_tpu import config as jc
from orb_slam_tpu.frontend import extractor_batched as jeb
from orb_slam_tpu.geometry import camera as jcam
from orb_slam_tpu.pipeline import frame_step as jfs, track_kernels as jtk
from orb_slam_tpu_torch import config as tc, state as tst
from orb_slam_tpu_torch.pipeline import frame_step as tfs
from orb_slam_tpu_torch.pipeline import track_kernels as ttk
from torch_port_util import desc_bits, np_of, t_of

W, H = 320, 240
CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, k1=0.0, k2=0.0, p1=0.0,
           p2=0.0, k3=0.0, width=W, height=H)
EXT = dict(n_features=500, max_keypoints=512)
MAP_VIEWS, TRACKED = (0, 3, 6), (7, 8, 9)
SEED = 7


def test_renderer_copy_matches_bench(world):
    jcfg, _, a, _ = world
    b = bench.SceneRenderer(np.random.default_rng(SEED), jcfg.camera.K, W, H)
    for i in (0, 50):
        np.testing.assert_array_equal(syn.pose_at(i)[0], bench.pose_at(i)[0])
        np.testing.assert_array_equal(syn.pose_at(i)[1], bench.pose_at(i)[1])
        np.testing.assert_array_equal(a.render(*syn.pose_at(i)),
                                      b.render(*bench.pose_at(i)))


@pytest.fixture(scope="module")
def world():
    jcfg = jc.SystemConfig(camera=jc.CameraConfig(**CAM),
                           extractor=jc.ExtractorConfig(**EXT))
    tcfg = tc.SystemConfig(camera=tc.CameraConfig(**CAM),
                           extractor=tc.ExtractorConfig(**EXT))
    # the map is built from the JAX package's keypoints
    renderer, arrays = syn.tracking_world(
        lambda img: jeb.extract_batched(
            jnp.asarray(img), jcfg.extractor, EXT["n_features"],
            EXT["max_keypoints"], False),
        jcfg.camera.K, MAP_VIEWS, window=2048, pool=4096, width=W, height=H,
        seed=SEED)
    return jcfg, tcfg, renderer, arrays


def _jax_state(arrays):
    ints = ("sel", "last_level", "prev_lm_matches")
    return {k: jnp.asarray(np.asarray(v, np.int32) if k in ints else v)
            for k, v in arrays.items()}


def test_frame_step_chain_matches_jax(world):
    jcfg, tcfg, renderer, arrays = world
    jcamp = jcam.make_camera(jcfg.camera)
    tcamp = tst.camera_from_numpy(
        {k: np_of(getattr(jcamp, k)) for k in jcamp._fields}, device="cpu")
    js = _jax_state(arrays)
    ts = tst.state_from_numpy(arrays, device="cpu")
    names = tst.FrameState._fields
    for i in TRACKED:
        img = renderer.render(*syn.pose_at(i))
        jo = jfs.frame_step(
            jnp.asarray(img), *[js[n] for n in names], jcamp,
            ext_cfg=jcfg.extractor, matcher_cfg=jcfg.matcher,
            solver_cfg=jcfg.solver, use_pallas=False)
        to = tfs.frame_step(
            img, *ts, tcamp, ext_cfg=tcfg.extractor,
            matcher_cfg=tcfg.matcher, solver_cfg=tcfg.solver, device="cpu")

        v = np_of(jo.kp_valid)
        np.testing.assert_array_equal(np_of(to.kp_valid), v)
        np.testing.assert_array_equal(np_of(to.level), np_of(jo.level))
        np.testing.assert_array_equal(np_of(to.xy), np_of(jo.xy))
        np.testing.assert_allclose(np_of(to.xy_und), np_of(jo.xy_und),
                                   atol=1e-4)
        np.testing.assert_allclose(np_of(to.angle)[v], np_of(jo.angle)[v],
                                   atol=1e-5)
        bits = desc_bits(np_of(to.desc)[v], np_of(jo.desc)[v])
        assert bits.max() <= 2 and (bits == 0).mean() >= 0.99

        jb, tb = np_of(jo.host_blob), np_of(to.host_blob)
        np.testing.assert_allclose(tb[:12], jb[:12], atol=1e-4)
        np.testing.assert_allclose(tb[12:16], jb[12:16], atol=2)
        assert (tb[16:] == jb[16:]).mean() >= 0.98
        np.testing.assert_array_equal(np_of(to.pid_global), tb[16:])
        assert tb[15] >= 100, "the frame must track"
        Rg, tg = syn.pose_at(i)
        c = syn.camera_center(tb[:9].reshape(3, 3), tb[9:12])
        assert np.linalg.norm(c - syn.camera_center(Rg, tg)) < 0.05

        js.update(last_desc=jo.desc, last_level=jo.level,
                  last_angle=jo.angle, last_pos=jo.next_last_pos,
                  last_valid=jo.next_last_valid, mp_visible=jo.mp_visible,
                  mp_found=jo.mp_found, R_prev=js["R_last"],
                  t_prev=js["t_last"], R_last=jo.R, t_last=jo.t,
                  prev_lm_matches=jo.lm_matches)
        ts = tst.chain(ts, to)
    # the landmark counts after three frames
    vis_t, vis_j = np_of(ts.mp_visible), np_of(js["mp_visible"])
    assert np.abs(vis_t - vis_j).max() <= 1
    assert (vis_t == vis_j).mean() >= 0.98
    assert (np_of(ts.mp_found) == np_of(js["mp_found"])).mean() >= 0.98
    assert int(ts.prev_lm_matches) == int(js["prev_lm_matches"])


def test_tracking_megastep_alone():
    _, args = ge.entry()
    (cur_xy, cur_desc, cur_level, cur_angle, cur_valid, inv_s2,
     last_pos, last_desc, last_level, last_angle, last_valid,
     mp_pos, mp_desc, mp_normal, mp_min, mp_max, mp_valid, _, _) = map(
        np_of, args)
    _, cam, cfg = ge._example_tracking_args()
    # start the LM away from the truth so both solvers take real steps
    R0 = np.eye(3, dtype=np.float32)
    t0 = np.array([0.03, -0.02, 0.05], np.float32)
    R_j, t_j, a_j, inl_j, vis_j, st_j = jtk.tracking_megastep(
        *map(jnp.asarray, (cur_xy, cur_desc, cur_level, cur_angle, cur_valid,
                           inv_s2, last_pos, last_desc, last_level,
                           last_angle, last_valid, mp_pos, mp_desc,
                           mp_normal, mp_min, mp_max, mp_valid, R0, t0)),
        cam, cfg.solver)
    tcam = tst.camera_from_numpy({k: np_of(getattr(cam, k))
                                  for k in cam._fields}, device="cpu")
    i32 = lambda a: t_of(np.asarray(a).view(np.int32))      # noqa: E731
    R_t, t_t, a_t, inl_t, vis_t, st_t = ttk.tracking_megastep(
        t_of(cur_xy), i32(cur_desc), t_of(cur_level, torch.int64),
        t_of(cur_angle), t_of(cur_valid), t_of(inv_s2), t_of(last_pos),
        i32(last_desc), t_of(last_level, torch.int64), t_of(last_angle),
        t_of(last_valid), t_of(mp_pos), i32(mp_desc), t_of(mp_normal),
        t_of(mp_min), t_of(mp_max), t_of(mp_valid), t_of(R0), t_of(t0),
        tcam, tc.SolverConfig())
    np.testing.assert_allclose(np_of(R_t), np_of(R_j), atol=1e-5)
    np.testing.assert_allclose(np_of(t_t), np_of(t_j), atol=1e-5)
    np.testing.assert_array_equal(np_of(a_t.valid), np_of(a_j.valid))
    v = np_of(a_j.valid)
    np.testing.assert_array_equal(np_of(a_t.point_idx)[v],
                                  np_of(a_j.point_idx)[v])
    np.testing.assert_array_equal(np_of(inl_t), np_of(inl_j))
    np.testing.assert_array_equal(np_of(vis_t), np_of(vis_j))
    for k in st_j:
        assert int(st_t[k]) == int(st_j[k]), k
    assert int(st_t["n_inliers"]) > 400


def test_frame_step_needs_a_card_or_the_cpu(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, renderer, arrays = world
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.state_from_numpy(arrays)
    ts = tst.state_from_numpy(arrays, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfs.frame_step(np.zeros((H, W), np.uint8), *ts, None,
                       ext_cfg=tcfg.extractor, matcher_cfg=tcfg.matcher,
                       solver_cfg=tcfg.solver)
