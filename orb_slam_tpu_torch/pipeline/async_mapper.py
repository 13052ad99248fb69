"""Asynchronous keyframe-rate work (port of
``orb_slam_tpu.pipeline.async_mapper``): local mapping and place
recognition on a worker thread, off the tracking path.

The reference runs LocalMapping and LoopClosing on their own threads over a
mutex-guarded map (src/main.cc:123-133).  Here, as in the JAX package:

  * on keyframe insertion the tracker snapshots the SlamMap and submits it
    to the worker, which runs ``LocalMapper.process_keyframe`` and then
    ``LoopCloser.process_keyframe`` (loop detection, the check and the
    correction of a verified loop) on the snapshot while the tracker keeps
    tracking against its own map;
  * while the worker is busy the tracker inserts no keyframe (the
    reference's SetAcceptKeyFrames backpressure, src/LocalMapping.cc:
    522-532), and signals keyframe pressure through two events, cleared on
    each submission (``interrupt_ba``, ``kf_queued``);
  * when the worker finishes, the tracker adopts its map and re-applies the
    landmark visible/found counts it accumulated meanwhile
    (``Tracker._commit_mapping``); a job that closed a loop re-anchors the
    tracker's last pose.

Where the port differs:

  * The snapshot is a deep copy.  JAX maps are immutable, so the JAX
    snapshot shares the device arrays; the port's tables are written in
    place (``mapping/mapstore.py``), so every MapState tensor is cloned
    (about 29 MiB at the default MapConfig) with the host mirrors and
    lists, and neither side's writes reach the other.
  * On the card the worker runs on its own CUDA stream.  The clone waits on
    an event recorded on the tracker's stream; each result carries an event
    recorded on the worker's stream after its last write, and the
    tracker's stream waits on it before it reads the adopted tables.
    Tensors that cross streams are marked with ``record_stream``, so the
    caching allocator does not hand their memory out while the other
    stream may still use it.
  * The worker's stage timer waits for its own stream only.

The LoopCloser is not part of the snapshot: the worker and the tracker
share one, as in the JAX package.  That is safe because there is one
writer at a time: the worker writes it during a job, and the tracker
touches it only with the worker idle (keyframe insertion and compaction
happen when the worker is not busy, relocalisation flushes it first, a
reset flushes it first).

A worker error is raised at the next ``poll`` or ``flush``; nothing retries
it or runs it elsewhere.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Optional

import numpy as np
import torch

from ..mapping import mapstore
from ..utils.timing import GLOBAL_TIMER as _timer


def snapshot_map(smap: mapstore.SlamMap,
                 stream: Optional[torch.cuda.Stream] = None
                 ) -> mapstore.SlamMap:
    """A copy of `smap` that shares nothing with it: every MapState tensor
    cloned, the host mirrors, arrays and lists copied.  With `stream` (a
    CUDA stream), the clones run there after the work already queued on
    the current stream.  The LoopCloser is not copied: worker and tracker
    share it, as in the JAX package, with one writer at a time (see the
    module docstring)."""
    src = smap.state
    if stream is None:
        state = mapstore.MapState(*(t.clone() for t in src))
    else:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(stream.device))
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            state = mapstore.MapState(*(t.clone() for t in src))
        for t in src:
            t.record_stream(stream)
    return dataclasses.replace(
        smap, state=state,
        parent=smap.parent.copy(),
        loop_edges=list(smap.loop_edges),
        kf_frame_id=smap.kf_frame_id.copy(),
        kf_timestamp=smap.kf_timestamp.copy(),
        obs_np=smap.obs_np.copy(),
        kf_valid_np=smap.kf_valid_np.copy(),
        mp_valid_np=smap.mp_valid_np.copy(),
        host={k: v.copy() for k, v in smap.host.items()})


@dataclasses.dataclass
class MappingResult:
    smap: mapstore.SlamMap
    kf: int
    metrics: dict
    snap_visible: torch.Tensor       # stat baselines at submission time
    snap_found: torch.Tensor
    remap_lut: Optional[np.ndarray]  # old->new point ids if pool compacted
    culled_kfs: list
    error: Optional[Exception] = None
    # recorded on the worker's stream after the job's last write (card)
    done: Optional[torch.cuda.Event] = None


class AsyncMapper:
    """Single-worker mapping thread with a one-deep submission queue.

    service_polls > 0 pins the worker's visible service interval to exactly
    that many poll() calls (one per tracked frame): poll() withholds the
    result until the N-th call after submit, then blocks for it.  Commit
    times, and every keyframe decision after them, then no longer depend on
    the machine's load.  0 = live timing.  flush() bypasses the pin."""

    def __init__(self, local_mapper, loop_closer=None, service_polls: int = 0,
                 device: torch.device = torch.device("cpu")):
        self.local_mapper = local_mapper
        self.loop_closer = loop_closer
        self.device = device
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self._in: "queue.Queue" = queue.Queue(maxsize=1)
        self._out: "queue.Queue" = queue.Queue(maxsize=1)
        self._busy = False
        self._service_polls = int(service_polls)
        self._polls_since_submit = 0
        # keyframe-pressure signals from the tracker (InterruptBA and
        # CheckNewKeyFrames, see LocalMapper.process_keyframe): set while
        # a job is in flight, cleared on the next submission
        self.interrupt_ba = threading.Event()
        self.kf_queued = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def busy(self) -> bool:
        return self._busy

    def submit(self, smap: mapstore.SlamMap, kf: int):
        if self._busy:
            raise RuntimeError("submit while the mapping worker is busy "
                               "(backpressure violated)")
        self._busy = True
        self.interrupt_ba.clear()
        self.kf_queued.clear()
        self._polls_since_submit = 0
        snap = snapshot_map(smap, self._stream)
        self._in.put((snap, kf, smap.state.mp_visible, smap.state.mp_found))

    def poll(self) -> Optional[MappingResult]:
        """Non-blocking: the finished result, or None.  Under a pinned
        service interval the result becomes visible at exactly the N-th
        poll after submit, blocking for the worker if needed."""
        if self._service_polls > 0 and self._busy:
            self._polls_since_submit += 1
            if self._polls_since_submit < self._service_polls:
                return None
            return self.flush()
        try:
            res = self._out.get_nowait()
        except queue.Empty:
            return None
        return self._deliver(res)

    def flush(self, timeout: Optional[float] = 300.0
              ) -> Optional[MappingResult]:
        """Block until the in-flight job (if any) completes.  Raises
        TimeoutError if it has not after `timeout` seconds (None = wait
        without limit); the job then stays in flight."""
        if not self._busy:
            return None
        try:
            res = self._out.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"the mapping worker did not finish within {timeout} s"
            ) from None
        return self._deliver(res)

    def shutdown(self):
        self._in.put(None)
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            raise RuntimeError("the mapping worker did not stop")

    # ------------------------------------------------------------------
    def _deliver(self, res: MappingResult) -> MappingResult:
        """Hand a finished job to the caller's stream: wait for the
        worker's writes and mark the adopted tables as used there."""
        self._busy = False
        if res.error is not None:
            raise res.error
        if res.done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(res.done)
            for t in res.smap.state:
                t.record_stream(cur)
        return res

    def _run(self):
        ctx = contextlib.nullcontext()
        if self._stream is not None:
            torch.cuda.set_device(self.device)
            _timer.set_thread_sync(self._stream.synchronize)
            ctx = torch.cuda.stream(self._stream)
        with ctx:
            while True:
                item = self._in.get()
                if item is None:
                    return
                self._out.put(self._job(*item))

    def _job(self, smap, kf, snap_vis, snap_found) -> MappingResult:
        res = MappingResult(smap=smap, kf=kf, metrics={},
                            snap_visible=snap_vis, snap_found=snap_found,
                            remap_lut=None, culled_kfs=[])
        try:
            smap.last_compaction_lut = None
            res.metrics = self.local_mapper.process_keyframe(
                smap, kf, interrupt_ba=self.interrupt_ba.is_set,
                kf_queued=self.kf_queued.is_set)
            # a compaction during mapping remapped point ids; the tracker
            # remaps its associations through the LUT at commit
            res.remap_lut = smap.last_compaction_lut
            smap.last_compaction_lut = None
            res.culled_kfs = list(self.local_mapper.last_culled_kfs or [])
            lc = self.loop_closer
            if lc is not None and lc.db is not None:
                # culled keyframes leave the place-recognition database
                # (the list is this pass's own: the local mapper resets it
                # on entry, ROADMAP Queue 3 known issue 2)
                for ck in res.culled_kfs:
                    lc.db = lc.db.remove(ck)
                    lc.kf_bow.pop(ck, None)
            if lc is not None and lc.voc is not None:
                with _timer.stage("mapping", "loopClosing"):
                    res.metrics.update(lc.process_keyframe(smap, kf))
        except Exception as e:  # raised at the next poll / flush
            res.error = e
        if self._stream is not None:
            res.done = torch.cuda.Event()
            res.done.record(self._stream)
        return res
