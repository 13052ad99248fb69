"""The steered-BRIEF sampling pattern (port of ``orb_slam_tpu.ops.brief``).

The 256-pair pattern is the public ORB constant (bit_pattern_31, reproduced
at ORBextractor.cc:197-455).  The port keeps its own copy,
``data/brief_pattern.npy`` (int32 [256, 4] = x1, y1, x2, y2 per pair);
``tests/test_torch_config.py`` holds it equal to the JAX package's file.
Descriptors are 8 32-bit words per keypoint, bit b of word w holding pair
32w+b, stored as int32 (bit-identical to the JAX package's uint32).
"""
from __future__ import annotations

import os

import numpy as np

_PATTERN_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                             "brief_pattern.npy")
_PATTERN = np.load(os.path.abspath(_PATTERN_PATH)).astype(np.float32)
# sample points: [512, 2] alternating (x1,y1),(x2,y2) per pair
_POINTS = _PATTERN.reshape(256, 2, 2).reshape(512, 2)
