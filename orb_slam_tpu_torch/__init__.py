"""orb_slam_tpu_torch — the PyTorch/CUDA port of ``orb_slam_tpu``.

The JAX package beside it is the reference; every module here mirrors the
module of the same path there and is held against it by the differential
tests in ``tests/test_torch_*.py``.  The two Pallas kernels of the JAX
package are hand-written CUDA C++ for Hopper (``csrc/``), each with a plain
PyTorch version that the wrapper runs for CPU tensors.

This package imports neither ``jax`` nor ``orb_slam_tpu``.
"""

__version__ = "0.1.0"


def load_system(settings_path: str, width: int = 640, height: int = 480,
                device=None):
    """A System from a reference-format Settings.yaml, on `device` (cuda
    unless the caller asks for the CPU).  The image size is not stored in
    that format, so the caller passes it.  The imports are lazy, so that
    ``import orb_slam_tpu_torch`` stays light."""
    from .dataio.settings import config_from_settings
    from .pipeline.system import System
    return System.create(config_from_settings(settings_path, width, height),
                         device=device)
