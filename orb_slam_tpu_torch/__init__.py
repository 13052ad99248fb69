"""orb_slam_tpu_torch — the PyTorch/CUDA port of ``orb_slam_tpu``.

The JAX package beside it is the reference; every module here mirrors the
module of the same path there and is held against it by the differential
tests in ``tests/test_torch_*.py``.  The two Pallas kernels of the JAX
package are hand-written CUDA C++ for Hopper (``csrc/``), each with a plain
PyTorch version that the wrapper runs for CPU tensors.

This package imports neither ``jax`` nor ``orb_slam_tpu``.
"""

__version__ = "0.1.0"
