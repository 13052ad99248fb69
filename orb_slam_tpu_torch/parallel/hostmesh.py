"""Device meshes for the sharded solvers, on ``torch.distributed`` (port of
``orb_slam_tpu.parallel.hostmesh``).

A mesh is a grid of shard slots with axis names.  Each slot is a device of
one process (``MeshDevice``); a process computes the shards whose slots it
owns and every psum is

  * a sum over the process's own shards, on the device the replicated
    state lives on,
  * then, when more than one process joined, one ``all_reduce`` over the
    process group.

One process may own several slots on one device: these are the port's
virtual devices, the counterpart of XLA's virtual host devices
(``--xla_force_host_platform_device_count``).  A process declares a
virtual count for a device kind (``declare_virtual_devices``); the tests
reach the sharded path on one CPU that way, and ``chip_smoke.py`` on one
card.  Without a declaration the count is the physical one: the CUDA
cards, or one CPU.  Shards on one device share its compute, so their
times check the program, not scaling.

The layout follows the JAX package's: the LANDMARK (data) axis packs
each process's local devices, so the per-LM-iteration psum of reduced
camera systems stays on the fast local links, and the KEYFRAME-BLOCK
(model) axis spans processes.

Environment (the JAX package's contract):
  ORB_SLAM_TPU_COORDINATOR  host:port of process 0
  ORB_SLAM_TPU_NUM_PROCS    total processes
  ORB_SLAM_TPU_PROC_ID      this process's index
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

_VIRTUAL: dict = {}          # device kind -> declared local device count


def physical_device_count(kind: str) -> int:
    """The local devices of a kind this machine has: its CUDA cards, or
    one CPU."""
    if kind == "cuda":
        return torch.cuda.device_count()
    if kind == "cpu":
        return 1
    raise ValueError(f"unsupported device kind {kind!r}")


def declare_virtual_devices(kind: str, n: Optional[int]) -> Optional[int]:
    """Declare `n` local devices of `kind` for this process (None: back to
    the physical count).  Slot i is physical device i mod the physical
    count.  Returns the previous declaration."""
    physical_device_count(kind)                  # validates the kind
    prev = _VIRTUAL.get(kind)
    if n is None:
        _VIRTUAL.pop(kind, None)
    else:
        if n < 1:
            raise ValueError(f"virtual device count must be >= 1, got {n}")
        _VIRTUAL[kind] = int(n)
    return prev


@contextlib.contextmanager
def virtual_devices(kind: str, n: Optional[int]):
    """declare_virtual_devices for the duration of a block."""
    prev = declare_virtual_devices(kind, n)
    try:
        yield
    finally:
        declare_virtual_devices(kind, prev)


def local_device_count(kind: str) -> int:
    """This process's devices of a kind: the declared virtual count, else
    the physical one (the port's ``jax.local_device_count()``)."""
    return _VIRTUAL.get(kind) or physical_device_count(kind)


def local_devices(kind: str) -> List[torch.device]:
    n = local_device_count(kind)
    if kind == "cpu":
        return [torch.device("cpu")] * n
    phys = physical_device_count(kind)
    return [torch.device(kind, i % phys) for i in range(n)] if phys else []


def process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MeshDevice(NamedTuple):
    """One shard slot: a device of one process."""

    process: int
    device: torch.device


def global_devices(kind: str) -> List[MeshDevice]:
    """Every process's local devices of a kind, by process then local index
    (the order of ``jax.devices()``).  Processes are taken to hold the same
    local devices, as the JAX package's hosts do."""
    loc = local_devices(kind)
    return [MeshDevice(p, d) for p in range(process_count()) for d in loc]


def device_count(kind: str) -> int:
    """The devices a sharded solve could use (``len(jax.devices())``)."""
    return process_count() * local_device_count(kind)


def _grid(devs: Sequence[MeshDevice], shape) -> np.ndarray:
    g = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        g[i] = d
    return g.reshape(shape)


class Mesh:
    """A grid of shard slots with axis names (``jax.sharding.Mesh``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d grid, axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        # set to a list to collect (start, end) CUDA event pairs around
        # every psum (chip_smoke.py's psum share); None records nothing
        self.psum_events: Optional[list] = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def own_shards(self) -> List[tuple]:
        """(shard index, torch.device) of every slot this process owns, in
        flat (row-major) order."""
        me = process_index()
        return [(i, d.device) for i, d in enumerate(self.devices.reshape(-1))
                if d.process == me]

    def psum(self, parts: Sequence[Sequence[torch.Tensor]],
             home: torch.device) -> List[torch.Tensor]:
        """The all-shard sum of per-shard tensor lists: parts[s] is shard
        s's list (this process's shards, in own_shards order), all lists
        alike in shape.  Summed on `home` in shard order, then, across
        processes, one all_reduce of the lists flattened together.  Every
        process must own a shard of the mesh."""
        if not parts:
            raise ValueError("this process owns no shard of the mesh")
        ev = None
        if self.psum_events is not None and home.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        acc = [p.to(home) for p in parts[0]]
        for more in parts[1:]:
            acc = [a + p.to(home) for a, p in zip(acc, more)]
        if process_count() > 1:
            flat = torch.cat([a.reshape(-1) for a in acc])
            dist.all_reduce(flat)
            out, o = [], 0
            for a in acc:
                out.append(flat[o:o + a.numel()].reshape(a.shape))
                o += a.numel()
            acc = out
        if ev is not None:
            ev[1].record()
            self.psum_events.append(ev)
        return acc

    def gather(self, parts: dict, shape, dtype, home: torch.device):
        """The full [D, ...] array of a sharded output from each process's
        own shards {shard index: tensor}: every process writes its rows
        into zeros and one all_reduce sums them, an all-gather that any
        backend runs on any device (gloo's all_gather takes no CUDA
        tensor).  Exact: each row is one process's values plus zeros."""
        full = torch.zeros((self.size,) + tuple(shape), dtype=dtype,
                           device=home)
        for d, x in parts.items():
            full[d] = x.to(device=home, dtype=dtype)
        if process_count() > 1:
            dist.all_reduce(full)
        return full

    def __repr__(self):
        return f"Mesh({self.shape})"


def maybe_init_distributed(device=None, timeout_s: float = 300.0) -> bool:
    """Join a ``torch.distributed`` process group from the environment, if
    configured.  Returns True when running multi-process.

    The backend: ``gloo`` for CPU tensors, and also when the ranks share a
    card (NCCL refuses two ranks on one GPU); ``nccl`` when every rank has
    a card of its own.  The ranks are taken to run on this machine, so
    they share a card when there are fewer cards than ranks; rank r then
    uses card r mod the card count."""
    coord = os.environ.get("ORB_SLAM_TPU_COORDINATOR")
    if not coord:
        return False
    n = int(os.environ.get("ORB_SLAM_TPU_NUM_PROCS", "1"))
    pid = int(os.environ.get("ORB_SLAM_TPU_PROC_ID", "0"))
    if n <= 1:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    kind = resolve_device(device).type
    own_card = kind == "cuda" and torch.cuda.device_count() >= n
    if kind == "cuda":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if own_card else "gloo", init_method=f"tcp://{coord}",
        world_size=n, rank=pid, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_host_mesh(data_parallel: Optional[int] = None,
                   model_parallel: Optional[int] = None,
                   data_axis: str = "data", model_axis: str = "model",
                   device=None) -> Mesh:
    """2D (model x data) mesh over all global devices of `device`'s kind,
    the data axis packed along each process's local devices and the model
    axis spanning processes.  Defaults: data = local device count, model =
    process count.  Raises when the mesh needs more devices than there
    are."""
    kind = resolve_device(device).type
    devs = global_devices(kind)
    n_local = local_device_count(kind)
    n_hosts = max(1, len(devs) // max(n_local, 1))
    dp = data_parallel or n_local
    mp = model_parallel or n_hosts
    if dp * mp > len(devs):
        raise ValueError(
            f"mesh {mp}x{dp} needs {mp * dp} devices, have {len(devs)}")
    # global_devices orders by process then local index, so reshaping
    # [hosts, local] puts the fast (data) axis on one process's devices
    return Mesh(_grid(devs[: mp * dp], (mp, dp)), (model_axis, data_axis))


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device=None) -> Mesh:
    """1D mesh over the first n_devices global devices of `device`'s kind
    (all of them by default)."""
    kind = resolve_device(device).type
    devs = global_devices(kind)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"mesh of {n} needs {n} devices, have {len(devs)}")
    return Mesh(_grid(devs[:n], (n,)), (axis,))
