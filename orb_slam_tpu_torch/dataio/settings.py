"""Settings.yaml loader (port of ``orb_slam_tpu.dataio.settings``): reads the
reference's OpenCV-FileStorage settings format (Data/Settings.yaml, parsed
at src/main.cc:65 and src/Tracking.cc:52) into the port's SystemConfig.

The format is `%YAML:1.0` with flat dotted keys (`Camera.fx: 646.8`); the
reference file itself has entries with no space after the colon
(`Camera.k1:-0.4157`), which strict YAML parsers reject, so this is a
tolerant line parser rather than a YAML library.
"""
from __future__ import annotations

import re

from ..config import (
    CameraConfig, ExtractorConfig, SystemConfig, TrackerConfig,
)

_LINE = re.compile(r"^\s*([A-Za-z0-9_.]+)\s*:\s*(-?[0-9.eE+-]+)\s*$")


def parse_settings(path: str) -> dict:
    """{key: int or float} of every `key: number` line; comments (`#`),
    the `%YAML` directive and non-numeric entries are skipped."""
    vals = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].rstrip()
            if not line or line.startswith("%"):
                continue
            m = _LINE.match(line)
            if m:
                v = m.group(2)
                vals[m.group(1)] = float(v) if ("." in v or "e" in v.lower()) \
                    else int(v)
    return vals


def config_from_settings(path: str, width: int, height: int) -> SystemConfig:
    """A SystemConfig from a reference-format settings file.  The image size
    is not stored in that format, so the caller supplies it."""
    v = parse_settings(path)
    cam = CameraConfig(
        fx=float(v.get("Camera.fx", 500.0)),
        fy=float(v.get("Camera.fy", 500.0)),
        cx=float(v.get("Camera.cx", width / 2)),
        cy=float(v.get("Camera.cy", height / 2)),
        k1=float(v.get("Camera.k1", 0.0)),
        k2=float(v.get("Camera.k2", 0.0)),
        p1=float(v.get("Camera.p1", 0.0)),
        p2=float(v.get("Camera.p2", 0.0)),
        k3=float(v.get("Camera.k3", 0.0)),
        fps=float(v.get("Camera.fps", 30.0)),
        rgb=bool(int(v.get("Camera.RGB", 1))),
        width=width, height=height,
    )
    ext = ExtractorConfig(
        n_features=int(v.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(v.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(v.get("ORBextractor.nLevels", 8)),
        fast_threshold=int(v.get("ORBextractor.fastTh", 20)),
        score_harris=int(v.get("ORBextractor.nScoreType", 1)) == 0,
    )
    # the keyframe cadence derived from the frame rate (src/Tracking.cc:78-79)
    trk = TrackerConfig(
        max_frames_between_kf=int(round(18.0 * cam.fps / 30.0)),
        use_motion_model=bool(int(v.get("UseMotionModel", 1))),
    )
    return SystemConfig(camera=cam, extractor=ext, tracker=trk)
