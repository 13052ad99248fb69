"""The port's way in from disk on the CPU: the settings loader, the PNG
decoder, the TUM and KITTI readers, the viz exports and the CLI.

- Settings: ``parse_settings`` equals the JAX package's dict and
  ``config_from_settings`` its SystemConfig, field for field, on the
  reference format (entries with no space after the colon included).
- PNG: ``decode_gray`` equals PIL's ``Image.open(p).convert("L")`` as
  float32, BIT-EQUAL (tolerance 0), on PIL-written grey, grey + alpha,
  RGB, RGBA and palette files (PIL's adaptive filters), on files written
  by ``chip_smoke.encode_png`` (row y filtered with type y % 5, every
  colour type, widths 1, 5 and 13 so that no row is a multiple of 4 or 8
  bytes), and on every one of the 2**24 RGB colours.  The compiled
  unfilter equals the plain one byte for byte; interlaced, 16-bit and
  1-bit files, a bad CRC and a non-PNG file raise ValueError.
- Readers: ``TumSequence`` and ``KittiSequence`` equal the JAX package's
  on fixtures written here: timestamps, paths, every frame bit for bit,
  ``groundtruth``, ``groundtruth_poses``, the ``times.txt`` default.
- ``export_map_ply`` writes the JAX package's text for the same map;
  ``export_frame_png`` writes a picture.
- CLI: the port's ``main(..., device="cpu")`` on the 16-frame TUM fixture
  of tests/test_system_cli.py passes that test's assertions (the System
  path under it is held against JAX by test_torch_system.py; the JAX
  ``main`` is not run again).  The same run's System then saves a
  checkpoint, and a fresh System resumes it LOST and relocalizes on a
  frame of the fixture (tests/test_resume.py on the port, at this size).
"""
import dataclasses
import os
import struct
import textwrap
import zlib

import numpy as np
import pytest
from PIL import Image

import orb_slam_tpu.dataio.datasets as jds
import orb_slam_tpu.dataio.settings as jset
import orb_slam_tpu_torch.dataio.datasets as tds
import orb_slam_tpu_torch.dataio.settings as tset
from chip_smoke import encode_png
from orb_slam_tpu_torch.dataio import png
from synthetic import rotmat
from test_image_e2e import render_image

# ---------------------------------------------------------------------------
# settings
# ---------------------------------------------------------------------------

REFERENCE_SETTINGS = """\
    %YAML:1.0
    # Camera calibration
    Camera.fx: 268.9633
    Camera.fy: 269.9858
    Camera.cx: 157.6087
    Camera.cy: 114.6369
    Camera.k1:-0.4157
    Camera.k2: 0.2624
    Camera.k3:-0.1178
    Camera.p1: 0.0
    Camera.p2: 0.0
    Camera.fps: 8.0
    Camera.RGB: 1
    ORBextractor.nFeatures: 1000
    ORBextractor.scaleFactor: 1.2
    ORBextractor.nLevels: 8
    ORBextractor.fastTh: 20
    ORBextractor.nScoreType: 1
    UseMotionModel: 1
"""
# defaults for what is missing, BGR order, Harris scores, no motion model,
# a non-numeric entry and an exponent
SPARSE_SETTINGS = """\
    %YAML:1.0
    Camera.fx: 5.2e2
    Camera.RGB: 0
    Camera.fps: 20
    Camera.name: "kinect"
    ORBextractor.nScoreType: 0
    UseMotionModel: 0   # off
"""


@pytest.mark.parametrize("text", [REFERENCE_SETTINGS, SPARSE_SETTINGS],
                         ids=["reference", "sparse"])
def test_settings_equal_jax(tmp_path, text):
    p = tmp_path / "Settings.yaml"
    p.write_text(textwrap.dedent(text))
    jv, tv = jset.parse_settings(str(p)), tset.parse_settings(str(p))
    assert tv == jv and [type(v) for v in tv.values()] == \
        [type(v) for v in jv.values()]
    if text is REFERENCE_SETTINGS:
        assert tv["Camera.k1"] == -0.4157       # no space after the colon
    jc = jset.config_from_settings(str(p), width=320, height=240)
    tc = tset.config_from_settings(str(p), width=320, height=240)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _pil_gray(path):
    return np.asarray(Image.open(path).convert("L"), np.float32)


def _picture(rng, h, w, c):
    """Gradients, flat patches and noise, so PIL's adaptive filtering picks
    several filter types."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * (7 + 3 * k) + yy * (5 + k)) % 256
                     for k in range(c)], -1)
    noise = rng.integers(0, 256, (h, w, c))
    pick = (yy // 4 + xx // 4) % 3
    out = np.where(pick[..., None] == 0, base,
                   np.where(pick[..., None] == 1, noise, 128))
    return out.astype(np.uint8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_decode_equals_pil_on_pil_files(tmp_path, rng, mode):
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 3}[mode]
    a = _picture(rng, 29, 47, c)
    im = Image.fromarray(a[..., 0] if c == 1 else a)
    if mode == "P":
        im = im.convert("P", palette=Image.ADAPTIVE, colors=60)
    p = str(tmp_path / f"{mode}.png")
    im.save(p)
    assert Image.open(p).mode == mode
    got = png.decode_gray(p)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, _pil_gray(p))


def _filter_types(path):
    px, ctype, _ = png.read_png(path)
    with open(path, "rb") as f:
        buf = f.read()
    idat, pos = b"", 8
    while pos < len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        if kind == b"IDAT":
            idat += buf[pos + 8:pos + 8 + n]
        pos += 12 + n
    stride = px.shape[1] * px.shape[2] + 1
    return zlib.decompress(idat)[::stride][:px.shape[0]]


@pytest.mark.parametrize("width", [1, 5, 13])
@pytest.mark.parametrize("kind", ["grey", "grey_alpha", "rgb", "rgba",
                                  "palette"])
def test_decode_equals_pil_on_each_filter(tmp_path, rng, kind, width):
    h = 11
    if kind == "palette":
        pal = rng.integers(0, 256, (23, 3), dtype=np.uint8)
        data = encode_png(rng.integers(0, 23, (h, width), dtype=np.uint8),
                          palette=pal)
    else:
        c = ["grey", "grey_alpha", "rgb", "rgba"].index(kind) + 1
        data = encode_png(_picture(rng, h, width, c))
    p = str(tmp_path / f"{kind}{width}.png")
    with open(p, "wb") as f:
        f.write(data)
    assert list(_filter_types(p)) == [y % 5 for y in range(h)]
    np.testing.assert_array_equal(png.decode_gray(p), _pil_gray(p))


def test_compiled_and_plain_unfilter_agree(rng):
    for c, w in ((1, 13), (2, 7), (3, 40), (4, 9)):
        h = 17
        # every filter type on random rows (random filtered bytes make
        # every byte value and carry appear)
        rows = rng.integers(0, 256, (h, w * c + 1), dtype=np.uint8)
        rows[:, 0] = rng.permutation(np.arange(h) % 5)
        data = rows.tobytes()
        np.testing.assert_array_equal(png.unfilter(data, h, w * c, c),
                                      png.unfilter_plain(data, h, w * c, c))
    bad = np.zeros((2, 4), np.uint8)
    bad[1, 0] = 5
    for fn in (png.unfilter, png.unfilter_plain):
        with pytest.raises(ValueError, match="filter type 5"):
            fn(bad.tobytes(), 2, 3, 1)


def test_luma_equals_pil_on_every_colour():
    c = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(
        png.luma(rgb), np.asarray(Image.fromarray(rgb).convert("L"),
                                  np.float32))


def _patched(data: bytes, depth=None, interlace=None, crc=True) -> bytes:
    """`data` with its IHDR's bit depth or interlace method replaced."""
    ihdr = bytearray(data[16:29])
    if depth is not None:
        ihdr[8] = depth
    if interlace is not None:
        ihdr[12] = interlace
    c = zlib.crc32(bytes(ihdr), zlib.crc32(b"IHDR")) ^ (0 if crc else 1)
    return data[:16] + bytes(ihdr) + struct.pack(">I", c) + data[33:]


def test_unsupported_files_raise(tmp_path, rng):
    good = encode_png(_picture(rng, 6, 5, 3))
    cases = {
        "interlaced": (_patched(good, interlace=1), "interlaced"),
        "crc": (_patched(good, crc=False), "CRC"),
        "depth2": (_patched(good, depth=2), "bit depth 2"),
        "not_png": (b"GIF89a" + good[6:], "not a PNG"),
    }
    a16 = (rng.integers(0, 1 << 16, (6, 5))).astype(np.uint16)
    p16 = str(tmp_path / "16.png")
    Image.fromarray(a16).save(p16)
    p1 = str(tmp_path / "1.png")
    Image.fromarray(a16 > 30000).save(p1)
    for name, (data, msg) in cases.items():
        p = str(tmp_path / f"{name}.png")
        with open(p, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError, match=msg):
            png.decode_gray(p)
    with pytest.raises(ValueError, match="16-bit"):
        png.decode_gray(p16)
    with pytest.raises(ValueError, match="bit depth 1"):
        png.decode_gray(p1)
    # the untouched file decodes (the patching is what fails above)
    p = str(tmp_path / "good.png")
    with open(p, "wb") as f:
        f.write(good)
    np.testing.assert_array_equal(png.decode_gray(p), _pil_gray(p))


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def _same_seq(t, j):
    assert len(t) == len(j)
    assert t.timestamps == j.timestamps and t.paths == j.paths
    for (ta, ia), (tb, ib) in zip(t.frames(), j.frames()):
        assert ta == tb and ia.dtype == ib.dtype == np.float32
        np.testing.assert_array_equal(ia, ib)


def test_tum_reader_equals_jax(tmp_path, rng):
    root = tmp_path / "tum"
    (root / "rgb").mkdir(parents=True)
    lines = ["# color images", "# timestamp filename"]
    for i in range(4):
        name = f"rgb/{1305031102.175304 + i / 30:.6f}.png"
        Image.fromarray(_picture(rng, 30, 40, 3)).save(root / name)
        lines.append(f"{1305031102.175304 + i / 30:.6f} {name} extra")
    (root / "rgb.txt").write_text("\n".join(lines) + "\n\n")
    (root / "groundtruth.txt").write_text(
        "# ground truth\n" + "".join(
            f"{1305031102.17 + i / 100:.4f} " + " ".join(
                f"{v:.4f}" for v in rng.normal(size=7)) + "\n"
            for i in range(9)))
    t, j = tds.TumSequence.open(str(root)), jds.TumSequence.open(str(root))
    _same_seq(t, j)
    np.testing.assert_array_equal(t.groundtruth(), j.groundtruth())
    (root / "groundtruth.txt").unlink()
    assert t.groundtruth() is None and j.groundtruth() is None


@pytest.mark.parametrize("times", [True, False], ids=["times", "default"])
def test_kitti_reader_equals_jax(tmp_path, rng, times):
    root = tmp_path / "kitti"
    (root / "image_0").mkdir(parents=True)
    for i in (2, 0, 3, 1):                     # written out of order
        Image.fromarray(_picture(rng, 20, 30, 1)[..., 0]).save(
            root / "image_0" / f"{i:06d}.png")
    if times:
        (root / "times.txt").write_text(
            "".join(f"{0.103 * i:.6e}\n" for i in range(5)))
        np.savetxt(root / "poses.txt", rng.normal(size=(4, 12)))
    t = tds.KittiSequence.open(str(root))
    j = jds.KittiSequence.open(str(root))
    _same_seq(t, j)
    if times:
        np.testing.assert_array_equal(t.groundtruth_poses(),
                                      j.groundtruth_poses())
        assert t.groundtruth_poses().shape == (4, 3, 4)
    else:
        assert t.timestamps == [0.0, 0.1, 0.2, 0.3]
        assert t.groundtruth_poses() is None is j.groundtruth_poses()


# ---------------------------------------------------------------------------
# viz
# ---------------------------------------------------------------------------

def test_viz_exports(tmp_path, rng):
    import orb_slam_tpu.utils.viz as jviz
    import orb_slam_tpu_torch.utils.viz as tviz
    from orb_slam_tpu_torch.frontend.extractor import FrameFeatures
    from test_torch_checkpoint import jax_map, port_map_of
    jm = jax_map(rng)
    tm = port_map_of(jm)
    jp, tp = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jviz.export_map_ply(jp, jm)
    tviz.export_map_ply(tp, tm)
    assert open(tp).read() == open(jp).read()
    assert f"element vertex {int(jm.mp_valid_np.sum())}" in open(tp).read()
    tviz.export_map_png(str(tmp_path / "map.png"), tm)
    assert os.path.getsize(tmp_path / "map.png") > 1000
    import torch
    n = 64
    feats = FrameFeatures(
        xy=torch.from_numpy(rng.uniform(0, 60, (n, 2)).astype(np.float32)),
        response=torch.zeros(n), angle=torch.zeros(n),
        level=torch.zeros(n, dtype=torch.int32),
        desc=torch.zeros(n, 8, dtype=torch.int32),
        valid=torch.from_numpy(rng.uniform(size=n) > 0.2))
    p = str(tmp_path / "frame.png")
    tviz.export_frame_png(p, torch.from_numpy(_picture(rng, 64, 64, 1)[
        ..., 0].astype(np.float32)), feats,
        assoc_valid=rng.uniform(size=n) > 0.5, status="WORKING")
    assert os.path.getsize(p) > 5000


# ---------------------------------------------------------------------------
# the CLI, and a checkpoint of its System resumed in a fresh one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tum_dataset(tmp_path_factory):
    """tests/test_system_cli.py's 16-frame TUM fixture."""
    root = tmp_path_factory.mktemp("tum_seq")
    (root / "rgb").mkdir()
    rng = np.random.default_rng(7)
    n_pts = 500
    X = np.stack([
        rng.uniform(-6, 6, n_pts),
        rng.uniform(-3.5, 3.5, n_pts),
        rng.uniform(4, 10, n_pts),
    ], 1).astype(np.float32)
    patches = rng.uniform(0, 255, (n_pts, 9, 9)).astype(np.float32)
    K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]], np.float32)

    rgb_lines, gt_lines = [], []
    for i in range(16):
        R = rotmat([0, 1, 0], np.radians(0.3 * i))
        t = np.array([-0.09 * i, 0.0, 0.01 * i], np.float32)
        img = render_image(X, patches, R, t, K)
        name = f"rgb/{i:04d}.png"
        Image.fromarray(img.astype(np.uint8)).save(root / name)
        ts = i / 30.0
        rgb_lines.append(f"{ts:.4f} {name}")
        C = -R.T @ t
        gt_lines.append(f"{ts:.4f} {C[0]:.6f} {C[1]:.6f} {C[2]:.6f} 0 0 0 1")
    (root / "rgb.txt").write_text("# ts path\n" + "\n".join(rgb_lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def cli_run(tum_dataset, tmp_path_factory):
    import contextlib
    import io
    from orb_slam_tpu_torch.pipeline import system
    out_dir = str(tmp_path_factory.mktemp("results"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        s = system.main([
            "--dataset", "tum", "--root", tum_dataset, "--calib", "fr1",
            "--out-dir", out_dir, "--viz",
        ], device="cpu")
    return dict(system=s, out=buf.getvalue(), out_dir=out_dir)


def test_cli_main_runs_end_to_end(cli_run):
    """tests/test_system_cli.py's assertions, on the port."""
    captured, out_dir = cli_run["out"], cli_run["out_dir"]
    assert "map_initialized" in captured
    traj_path = os.path.join(out_dir, "KeyFrameTrajectory.txt")
    assert os.path.exists(traj_path)
    rows = open(traj_path).read().strip().split("\n")
    assert len(rows) >= 2 and len(rows[0].split()) == 8
    assert os.path.getsize(os.path.join(out_dir, "map.png")) > 1000
    assert "fps" in captured
    assert "ATE RMSE (Sim3-aligned)" in captured
    assert cli_run["system"].tracker.device.type == "cpu"


def test_cli_system_checkpoint_resumes(cli_run, tum_dataset, tmp_path):
    """save_checkpoint of the CLI's System, resume_checkpoint in a fresh
    one: LOST with the saved keyframes and their database rows, then a
    frame of the mapped region relocalizes and the next one tracks."""
    from orb_slam_tpu_torch.pipeline.system import System
    from orb_slam_tpu_torch.pipeline.tracker import TrackState
    sys_a = cli_run["system"]
    path = str(tmp_path / "map.npz")
    sys_a.save_checkpoint(path)
    smap = sys_a.tracker.slam_map
    sys_b = System.create(sys_a.cfg, device="cpu")
    sys_b.resume_checkpoint(path)
    tr = sys_b.tracker
    assert tr.state == TrackState.LOST
    assert tr.slam_map.n_kf == smap.n_kf and tr.slam_map.n_mp == smap.n_mp
    assert tr.frame_id == int(smap.kf_frame_id[:smap.n_kf].max()) + 1
    assert len(tr.loop_closer.db) == int(smap.kf_valid_np.sum())
    seq = tds.TumSequence.open(tum_dataset)
    frames = list(seq.frames())
    events = [sys_b.process_image(img, 10.0 + k / 30).get("event")
              for k, (_, img) in enumerate(frames[12:14])]
    assert events[0] == "relocalized", events
    assert tr.state == TrackState.WORKING and tr.trajectory[-1].tracked
    sys_b.shutdown()
