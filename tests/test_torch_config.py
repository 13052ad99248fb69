"""The port's config and BRIEF pattern are exact copies of the JAX
package's."""
import dataclasses

import numpy as np
import pytest

import orb_slam_tpu.config as jc
import orb_slam_tpu_torch.config as tc
from orb_slam_tpu.ops import brief as jbrief
from orb_slam_tpu_torch.ops import brief as tbrief

_CLASSES = [name for name, obj in vars(jc).items()
            if dataclasses.is_dataclass(obj) and isinstance(obj, type)]


def test_same_config_classes():
    assert set(_CLASSES) == {
        name for name, obj in vars(tc).items()
        if dataclasses.is_dataclass(obj) and isinstance(obj, type)}


@pytest.mark.parametrize("name", _CLASSES)
def test_fields_and_defaults_equal(name):
    jf = dataclasses.fields(getattr(jc, name))
    tf = dataclasses.fields(getattr(tc, name))
    assert [f.name for f in jf] == [f.name for f in tf]
    j_obj, t_obj = getattr(jc, name)(), getattr(tc, name)()
    for f in jf:
        jv, tv = getattr(j_obj, f.name), getattr(t_obj, f.name)
        if dataclasses.is_dataclass(jv):
            assert dataclasses.asdict(jv) == dataclasses.asdict(tv), f.name
        else:
            assert jv == tv and type(jv) is type(tv), f.name


@pytest.mark.parametrize("preset", ["tum_freiburg1_config",
                                    "tum_freiburg2_config"])
def test_presets_equal(preset):
    assert (dataclasses.asdict(getattr(jc, preset)())
            == dataclasses.asdict(getattr(tc, preset)()))


def test_derived_properties_equal():
    j, t = jc.SystemConfig(), tc.SystemConfig()
    np.testing.assert_array_equal(j.camera.K, t.camera.K)
    np.testing.assert_array_equal(j.camera.dist, t.camera.dist)
    np.testing.assert_array_equal(j.extractor.sigma2, t.extractor.sigma2)
    np.testing.assert_array_equal(j.extractor.scale_factors,
                                  t.extractor.scale_factors)


def test_brief_pattern_copy_equal():
    j = np.load(jbrief._PATTERN_PATH)
    t = np.load(tbrief._PATTERN_PATH)
    assert t.dtype == np.int32 and t.shape == (256, 4)
    np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(jbrief._POINTS, tbrief._POINTS)
