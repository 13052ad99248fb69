"""utils/profiling on torch.profiler: a trace of a block and its summary
by event name (mirrors tests/test_aux.py's case for the JAX package).  On
the CPU the trace holds CPU activity only; on the card `top_ops` sums the
kernels' device time, which chip_smoke.py and
scripts/torch_ba_city_bench.py --trace read there."""
import json
import os

import pytest
import torch

from orb_slam_tpu_torch.utils.profiling import device_trace, top_ops


def test_device_trace_top_ops(tmp_path):
    d = str(tmp_path / "trace")
    with device_trace(d, device="cpu"):
        x = torch.ones((128, 128))
        (x @ x).sum()
    ops = top_ops(d)
    assert ops and ops[0][0] >= 0.0
    assert all(isinstance(n, str) and n for _, n in ops)
    assert [d for d, _ in ops] == sorted((d for d, _ in ops), reverse=True)
    assert "aten::mm" in {n for _, n in ops}


def test_top_ops_sums_device_events_when_present(tmp_path):
    """A trace with device kernels is summed over them alone, per name,
    from the newest trace file; a directory without one raises."""
    with pytest.raises(FileNotFoundError):
        top_ops(str(tmp_path))
    ev = [dict(ph="X", cat="cpu_op", name="aten::mm", dur=900.0),
          dict(ph="X", cat="kernel", name="gemm", dur=1500.0),
          dict(ph="X", cat="kernel", name="gemm", dur=500.0),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", dur=250.0),
          dict(ph="i", cat="kernel", name="marker")]
    with open(os.path.join(tmp_path, "trace-1.json"), "w") as f:
        json.dump({"traceEvents": [dict(ph="X", cat="kernel", name="old",
                                        dur=1.0)]}, f)
    with open(os.path.join(tmp_path, "trace-2.json"), "w") as f:
        json.dump({"traceEvents": ev}, f)
    assert top_ops(str(tmp_path)) == [(2.0, "gemm"), (0.25, "Memcpy HtoD")]


def test_device_trace_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        with device_trace(str(tmp_path / "t")):
            pass
