"""Tracking state machine (port of ``orb_slam_tpu.pipeline.tracker``).

The host orchestrator of the per-frame pipeline (the Tracking thread of
src/Tracking.cc): states NOT_INITIALIZED -> INITIALIZING -> WORKING <->
LOST (Tracking.h:57-64).  Frames before the map exists are extracted at
init_features_mult x the feature budget and go through two-view
initialization; WORKING frames run ``frame_step`` (extraction + matching +
pose LM + landmark counts, kernels 1 and 2 inside), or ``frame_step_scan``
for frame_batch of them at once.

Keyframe-rate mapping runs either synchronously after the frame (pipeline
depth 0: it mutates the landmark tables in place) or, with
``async_mapping``, on the worker of ``async_mapper.py`` over a snapshot
(depth 1: frame i+1, or batch i+1, is dispatched before frame i is
retired); finished mapping work is committed at a frame boundary with the
pipeline drained.

Poses and associations the host needs live in numpy (from the per-frame
host blob and the map's host mirrors), so a WORKING frame reads the card
only at frame_step's two fallback decisions and at the blob fetch (one
fetch per batch).

A LOST frame runs BoW relocalisation (src/Tracking.cc:867-1036): database
candidates, descriptor matching against their landmarks, batched EPnP
RANSAC, pose refinement and local-map re-acquisition.  Every new keyframe
goes to the place-recognition database (``loop_closer.py``), on the worker
with async mapping.

``adopt_map`` resumes from a checkpointed map: tracking re-enters LOST
and relocalizes into it.

A mapping job or synchronous keyframe that closed a loop moved the whole
map: the last pose is carried along with the keyframe's correction and the
motion model is reset.

Not ported: the JAX package's ``prewarm_commit_variants`` (there is
nothing to compile) and ``_start_host_prefetch`` (a workaround for its
device link).
A partial flush of the batch buffer dispatches only its frames: the JAX
tracker pads it to frame_batch to keep one compiled program.
"""
from __future__ import annotations

import dataclasses
import enum
import warnings
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..device import resolve_device, upload
from ..frontend.extractor import FrameFeatures
from ..frontend.extractor_batched import extract_batched
from ..geometry import camera as cam_mod, se3
from ..mapping import mapstore
from ..ops import match as match_ops
from ..place import database as db_mod
from ..place import vocabulary as voc_mod
from ..solvers import initializer, pnp, pose_opt
from ..utils.timing import GLOBAL_TIMER as _timer
from .. import native
from . import frame as frame_mod
from . import frame_step as fs
from . import track_kernels as tk
from .async_mapper import AsyncMapper, MappingResult
from .local_mapper import LocalMapper
from .loop_closer import LoopCloser


def _orthonormalize_np(R: np.ndarray) -> np.ndarray:
    """Host-side SO(3) projection (SVD) of the motion-model velocity."""
    u, _, vt = np.linalg.svd(R.astype(np.float64))
    s = np.sign(np.linalg.det(u @ vt))
    return (u @ np.diag([1.0, 1.0, s]) @ vt).astype(np.float32)


def _moved(R, t, move):
    """A camera pose (R, t) tracked against a map that then moved by
    `move` = (R_g, t_g), in the moved map: T G."""
    R_g, t_g = move
    R = np.asarray(R)
    return (_orthonormalize_np(R @ R_g),
            (R @ t_g + np.asarray(t)).astype(np.float32))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


_FRAME_FIELDS = ("xy", "xy_und", "response", "angle", "level", "desc",
                 "kp_valid", "inv_sigma2", "sigma2")


def _frame_data(out, b: Optional[int] = None) -> frame_mod.FrameData:
    """The frame's features from a frame_step output, or row b of a
    frame_step_scan output."""
    fields = [getattr(out, n) for n in _FRAME_FIELDS]
    if b is not None:
        fields = fs.slice_frame(fields, b)
    xy, xy_und, response, angle, level, desc, kp_valid, inv_s2, s2 = fields
    return frame_mod.FrameData(
        feats=FrameFeatures(xy=xy, response=response, angle=angle,
                            level=level, desc=desc, valid=kp_valid),
        xy_und=xy_und, inv_sigma2=inv_s2, sigma2=s2)


def commit_stats(nvis, nfnd, cur_vis, cur_fnd, snap_vis, snap_fnd, lut,
                 mp_pos, pid):
    """The mapping commit's device work: re-apply the tracker's
    visible/found increments since the snapshot (cur - snap) onto the
    worker's counts (nvis, nfnd), through the worker's compaction LUT when
    it compacted the point pool (lut [P] old -> new id, -1 dropped; None
    otherwise), and gather the positions of the remapped associations pid.
    Returns (visible, found, positions)."""
    P = nvis.shape[0]
    dvis = cur_vis - snap_vis
    dfnd = cur_fnd - snap_fnd
    if lut is not None:
        tgt = torch.where(lut >= 0, lut, torch.full_like(lut, P))
        dvis = torch.zeros(P + 1, dtype=dvis.dtype,
                           device=dvis.device).index_add_(0, tgt, dvis)[:P]
        dfnd = torch.zeros(P + 1, dtype=dfnd.dtype,
                           device=dfnd.device).index_add_(0, tgt, dfnd)[:P]
    return nvis + dvis, nfnd + dfnd, mp_pos[torch.clamp(pid, min=0)]


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    INITIALIZING = 1
    WORKING = 2
    LOST = 3


@dataclass
class FrameRecord:
    frame_id: int
    timestamp: float
    R: np.ndarray
    t: np.ndarray
    tracked: bool


@dataclass
class Tracker:
    cfg: SystemConfig
    cam: cam_mod.CameraParams
    slam_map: mapstore.SlamMap
    local_mapper: LocalMapper
    device: torch.device
    async_mapper: Optional[AsyncMapper] = None
    loop_closer: Optional[LoopCloser] = None

    state: TrackState = TrackState.NOT_INITIALIZED
    frame_id: int = 0
    last_kf_frame_id: int = -10**9
    last_reloc_frame_id: int = -10**9
    ref_kf: int = -1
    n_ref_tracked: int = 0

    # motion model: velocity = T_cur * T_last^-1 (host numpy)
    vel_R: Optional[np.ndarray] = None
    vel_t: Optional[np.ndarray] = None

    _prev_localmap_matches: int = 0
    # cached local-map window selection (recomputed on map changes)
    _sel_cache: Optional[torch.Tensor] = None
    _sel_frame: int = -10**9
    _sel_dirty: bool = True
    # frames dispatched but not yet retired, and the device handles that
    # feed the next frame_step (rebuilt from host state when None)
    _pipe: List[dict] = field(default_factory=list)
    _chain: Optional[dict] = None
    # a keyframe forced under backpressure, inserted at the next frame
    # boundary with the pipeline drained
    _force_kf: bool = False
    # draining the pipeline for a finished mapping job that is not adopted
    # yet: the first keyframe due now waits for the commit in
    # _pending_kf (_keyframe_due), later ones meet a busy worker
    _adopting: bool = False
    _pending_kf: Optional[dict] = None
    # micro-batching: frames waiting for a batch dispatch, and the stacked
    # output holding the newest retired frame's features (sliced when
    # someone needs them)
    _batch_buf: List[dict] = field(default_factory=list)
    _last_stacked: Optional[tuple] = None
    # pinned keyframe schedule (replay harness): when set, NeedNewKeyFrame
    # is exactly "frame_id in this set"
    kf_schedule: Optional[set] = None
    # a commit carries its local BA's move of the reference keyframe onto
    # the last tracked pose (the reference's Tracking::UpdateLastFrame);
    # False replays the JAX tracker, which re-anchors after a closed loop
    # only
    reanchor_after_ba: bool = True
    last_frame: Optional[frame_mod.FrameData] = None
    last_R: Optional[np.ndarray] = None
    last_t: Optional[np.ndarray] = None
    last_assoc_pos: Optional[torch.Tensor] = None   # [N,3] per-slot landmark
    last_assoc_pid: Optional[np.ndarray] = None     # [N] global point ids
    last_assoc_valid: Optional[torch.Tensor] = None

    init_frame: Optional[frame_mod.FrameData] = None
    init_frame_id: int = -1
    init_timestamp: float = 0.0

    trajectory: List[FrameRecord] = field(default_factory=list)
    # RANSAC samples of two-view initialization and of relocalisation's
    # PnP: drawn from this CPU generator (seeded by cfg.seed), unless a
    # sampler is set — init_sampler(valid [N] bool tensor) ->
    # [S, sample_size] indices; pnp_sampler(valid [N] bool numpy,
    # n_samples, min_set) -> [n_samples, min_set] indices
    generator: Optional[torch.Generator] = None
    init_sampler: Optional[Callable] = None
    pnp_sampler: Optional[Callable] = None

    @staticmethod
    def create(cfg: SystemConfig, device=None) -> "Tracker":
        tcfg = cfg.tracker
        if tcfg.frame_batch > 1 and not tcfg.async_mapping:
            raise ValueError(
                "frame_batch > 1 requires async_mapping: synchronous "
                "keyframe mapping mutates the landmark tables mid-batch, "
                "invalidating the in-flight rows' associations")
        # the forced-keyframe cadence is max_frames_between_kf (mMaxFrames,
        # src/Tracking.cc:79) and a batched keyframe decision retires up to
        # frame_batch - 1 frames after the frame that triggered it: a
        # longer batch lags the policy past a forced-insertion interval
        max_fb = max(1, tcfg.max_frames_between_kf)
        if tcfg.frame_batch > max_fb:
            warnings.warn(
                f"frame_batch={tcfg.frame_batch} exceeds the keyframe "
                f"cadence bound max_frames_between_kf={max_fb}; clamping to "
                f"{max_fb} (an over-long batch delays keyframe decisions "
                "past the forced-insertion interval and starves the map)",
                stacklevel=2)
            cfg = cfg.replace(tracker=dataclasses.replace(
                tcfg, frame_batch=max_fb))
        dev = resolve_device(device)
        if dev.type == "cuda":
            # the card's path runs the compiled host graph ops, never the
            # numpy versions behind a failed build
            native.require_compiled()
        cam = cam_mod.make_camera(cfg.camera, device=dev)
        smap = mapstore.SlamMap.create(cfg.map, cfg.extractor.max_keypoints,
                                       device=dev)
        lm = LocalMapper(cfg=cfg, cam=cam)
        lc = LoopCloser(cfg=cfg, cam=cam)
        am = (AsyncMapper(lm, lc,
                          service_polls=cfg.tracker.mapper_service_polls,
                          device=dev)
              if cfg.tracker.async_mapping else None)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(cfg.seed)
        return Tracker(cfg=cfg, cam=cam, slam_map=smap, local_mapper=lm,
                       device=dev, async_mapper=am, loop_closer=lc,
                       generator=gen)

    # ------------------------------------------------------------------
    def process(self, feats: FrameFeatures, timestamp: float) -> dict:
        """Track one frame from pre-extracted features (staged path)."""
        self._drain_pipe()
        self._chain = None
        fd = frame_mod.build_frame(feats, self.cam, self.cfg.extractor)
        metrics = {"frame_id": self.frame_id, "state": self.state.name,
                   "n_kp": int(feats.valid.sum())}
        self._poll_mapper(metrics)
        if self.state in (TrackState.NOT_INITIALIZED,
                          TrackState.INITIALIZING):
            self._initialize(fd, timestamp, metrics)
        elif self.state == TrackState.WORKING:
            self._track(fd, timestamp, metrics)
        else:
            self._relocalize(fd, timestamp, metrics)
        self.frame_id += 1
        metrics["state_after"] = self.state.name
        metrics["n_map_points"] = self.slam_map.n_mp
        metrics["n_keyframes"] = self.slam_map.n_kf
        return metrics

    def process_image(self, image, timestamp: float) -> dict:
        """Track one frame from a raw grayscale image: WORKING frames run
        frame_step (or join the batch); other states extract first and
        take the staged path."""
        if self.state == TrackState.WORKING:
            metrics = {"frame_id": self.frame_id, "state": self.state.name}
            # commit finished mapping work first, with the pipeline drained
            # so in-flight associations can be remapped and revalidated
            if self.async_mapper is not None:
                res = self.async_mapper.poll()
                if res is not None:
                    with _timer.stage("tracking", "commitMapping"):
                        self._adopting = True
                        try:
                            self._drain_pipe()
                        finally:
                            self._adopting = False
                        move = self._commit_mapping(res, metrics)
                        self._insert_pending(res, move)
            if self._force_kf and self.state == TrackState.WORKING:
                with _timer.stage("tracking", "starvedKeyframe"):
                    self._starved_keyframe(metrics)
            if self.state == TrackState.WORKING:
                with _timer.stage("tracking", "trackFused"):
                    self._track_fused(image, timestamp, metrics)
                self.frame_id += 1
                metrics["state_after"] = self.state.name
                metrics["n_map_points"] = self.slam_map.n_mp
                metrics["n_keyframes"] = self.slam_map.n_kf
                return metrics
            # a drained in-flight frame lost tracking: this image takes the
            # staged path in the new state
        feats = self.extract(image)
        return self.process(feats, timestamp)

    # ------------------------------------------------------------------
    # async mapping: poll and commit (see async_mapper.py)
    # ------------------------------------------------------------------
    def _poll_mapper(self, metrics):
        if self.async_mapper is None:
            return
        res = self.async_mapper.poll()
        if res is not None:
            self._commit_mapping(res, metrics)

    def _commit_mapping(self, res: MappingResult, metrics):
        """Adopt the worker's map and re-apply the tracker's landmark
        visible/found increments since the snapshot (its only map writes
        between keyframes), remapped if the worker compacted the pool; the
        last tracked pose follows its keyframe's move.  Returns that move
        (R_g, t_g): a pose T tracked against the old map is T G in the
        new one; None where the pose stays (reanchor_after_ba off)."""
        P = self.cfg.map.max_points
        cur = self.slam_map.state
        old_host = self.slam_map.host
        new_map = res.smap
        nst = new_map.state
        dev = self.device
        if new_map.n_kf != self.slam_map.n_kf:
            raise RuntimeError(
                f"mapping result for keyframe {res.kf} is stale: the "
                f"tracker's map holds {self.slam_map.n_kf} keyframes, the "
                f"job's snapshot {new_map.n_kf}")
        metrics["mapping"] = res.metrics

        # remap + revalidate the last frame's associations (host)
        pid = self.last_assoc_pid
        if pid is not None:
            pid = self._remap_pid(pid, res)
        lut = (upload(res.remap_lut[:P].astype(np.int64), dev)
               if res.remap_lut is not None else None)
        pid_d = upload((pid if pid is not None
                        else np.zeros(1, np.int32)).astype(np.int64), dev)
        new_vis, new_fnd, assoc_pos = commit_stats(
            nst.mp_visible, nst.mp_found, cur.mp_visible, cur.mp_found,
            res.snap_visible, res.snap_found, lut, nst.mp_pos, pid_d)
        new_map.state = nst._replace(mp_visible=new_vis, mp_found=new_fnd)
        self.slam_map = new_map
        self._sel_dirty = True
        self._chain = None      # chained handles reference the old tables

        if pid is not None:
            self.last_assoc_pid = pid
            self.last_assoc_valid = pid_d >= 0
            self.last_assoc_pos = assoc_pos

        kf_valid = new_map.kf_valid_np
        loop = bool(res.metrics.get("loop_closed"))
        # the keyframe the last frame hangs on: the tracker's reference
        # keyframe, or the job's after a closed loop or a culled reference
        anchor = self.ref_kf
        if loop or not (0 <= anchor < len(kf_valid) and kf_valid[anchor]):
            anchor = res.kf
        if self.ref_kf >= 0 and (self.ref_kf >= len(kf_valid)
                                 or not kf_valid[self.ref_kf]):
            self.ref_kf = res.kf

        # the job moved the keyframes (its local BA; after a closed loop the
        # whole map, CorrectLoop, then src/LoopClosing.cc:551): carry the
        # anchor's move onto the last tracked pose, G^-1 = Twc_old o
        # Tcw_new, from the pose mirrors before and after the commit (no
        # device read), as the reference re-anchors the last frame on its
        # reference keyframe before each frame (Tracking::UpdateLastFrame).
        # The JAX tracker does so after a closed loop only.
        R_old, t_old = old_host["kf_R"][anchor], old_host["kf_t"][anchor]
        R_new, t_new = new_map.host["kf_R"][anchor], \
            new_map.host["kf_t"][anchor]
        move = (R_old.T @ R_new, R_old.T @ (t_new - t_old))
        if not (loop or self.reanchor_after_ba):
            return None
        if self.last_R is not None:
            self.last_R, self.last_t = _moved(self.last_R, self.last_t, move)
        if loop:
            # reset the motion model
            self.vel_R, self.vel_t = None, None
            self.local_mapper.refresh_point_stats(self.slam_map)
        return move

    @staticmethod
    def _remap_pid(pid, res: MappingResult) -> np.ndarray:
        """Per-slot landmark ids of a frame tracked against the snapshot
        map, in the job's map: remapped if the worker compacted the pool,
        -1 where the landmark is gone."""
        pid = np.asarray(pid)
        if res.remap_lut is not None:
            pid = np.where(pid >= 0, res.remap_lut[np.clip(pid, 0, None)],
                           -1)
        mp_valid = res.smap.mp_valid_np
        return np.where((pid >= 0) & mp_valid[np.clip(pid, 0, None)],
                        pid, -1).astype(np.int32)

    def finish(self):
        """Retire in-flight frames and commit in-flight mapping work
        (before exporting the trajectory or map)."""
        self._drain_pipe()
        if self.async_mapper is not None:
            res = self.async_mapper.flush()
            if res is not None:
                self._commit_mapping(res, {})

    def shutdown(self):
        """finish() and join the mapping worker (System::Shutdown joins
        the reference's threads before trajectory export)."""
        self.finish()
        if self.async_mapper is not None:
            self.async_mapper.shutdown()
            self.async_mapper = None

    def adopt_map(self, smap: mapstore.SlamMap):
        """Resume from a checkpointed map (mapping/checkpoint.py): tracking
        re-enters LOST (NOT_INITIALIZED for an empty map) and relocalizes
        into the loaded map.  In-flight frames are retired and in-flight
        mapping work committed first; every per-session cache is dropped
        (the _reset_map list, the frame chain, the last frame's
        associations).  Place recognition is rebuilt from the map's host
        descriptor mirrors, so resume reads nothing back from the device.
        Like the JAX tracker, _force_kf and _prev_localmap_matches are
        left as they were."""
        self.finish()
        self.slam_map = smap
        self.state = TrackState.LOST if smap.n_kf else \
            TrackState.NOT_INITIALIZED
        self.frame_id = (int(smap.kf_frame_id[: smap.n_kf].max()) + 1
                         if smap.n_kf else 0)
        live = np.where(smap.kf_valid_np[: smap.n_kf])[0]
        self.ref_kf = int(live[-1]) if len(live) else -1
        if self.ref_kf >= 0:
            self.last_R = smap.host["kf_R"][self.ref_kf].copy()
            self.last_t = smap.host["kf_t"][self.ref_kf].copy()
        self.last_frame = None
        self._last_stacked = None
        self._chain = None
        self._pipe = []
        self._batch_buf = []
        self._sel_cache = None
        self._sel_dirty = True
        self.vel_R, self.vel_t = None, None
        self.last_kf_frame_id = -10**9
        self.last_reloc_frame_id = -10**9
        self.n_ref_tracked = 0
        self.last_assoc_pid = None
        self.last_assoc_pos = None
        self.last_assoc_valid = None

        lc = self.loop_closer
        if lc is None:
            return
        # the configured or shipped vocabulary, else one trained on the
        # map's own descriptors
        lc.ensure_vocabulary(lambda: smap.host["kf_desc"][live][
            smap.host["kf_kp_valid"][live]][:20000])
        lc.db = db_mod.BowDatabase.create(
            smap.cfg.max_keyframes, self.cfg.extractor.max_keypoints)
        lc.kf_bow = {}
        for k in live:
            lc.add_keyframe(smap, int(k))
        lc.consistent_groups = []
        lc.last_loop_kf = -(10 ** 9)

    def extract(self, image) -> FrameFeatures:
        """Batched extraction (kernels 1 and 2).  Before the map exists the
        budget is init_features_mult x the runtime one (src/Tracking.cc:128);
        _compress_init reduces the init frames back to max_keypoints."""
        ecfg = self.cfg.extractor
        n_feat, cap = ecfg.n_features, ecfg.max_keypoints
        if (self.state in (TrackState.NOT_INITIALIZED,
                           TrackState.INITIALIZING)
                and ecfg.init_features_mult > 1):
            n_feat *= ecfg.init_features_mult
            cap *= ecfg.init_features_mult
        return extract_batched(image, ecfg, n_feat, cap, device=self.device)

    def _inlier_floor(self, frame_id: int) -> int:
        """TrackLocalMap acceptance floor: 50 inliers within mMaxFrames of a
        relocalisation, 30 otherwise (src/Tracking.cc:640-647)."""
        tcfg = self.cfg.tracker
        recent = (frame_id - self.last_reloc_frame_id
                  < tcfg.max_frames_between_kf)
        return (tcfg.min_localmap_inliers_reloc if recent
                else tcfg.min_localmap_inliers)

    # ------------------------------------------------------------------
    # WORKING: frame_step
    # ------------------------------------------------------------------
    def _track_fused(self, image, timestamp, metrics):
        tcfg = self.cfg.tracker
        # depth 1 with the async mapper: frame (batch) i+1 is dispatched
        # before frame (batch) i is retired; depth 0 without it, since
        # synchronous mapping mutates the tables an in-flight frame read
        depth = 1 if self.async_mapper is not None else 0
        if tcfg.frame_batch > 1:
            self._batch_buf.append(dict(
                image=image, timestamp=timestamp, metrics=metrics,
                frame_id=self.frame_id))
            if len(self._batch_buf) >= tcfg.frame_batch:
                self._dispatch_batch()
                while len(self._pipe) > depth:
                    self._retire_batch()
            return

        st = self.slam_map.state
        chain = self._chain if self._chain is not None else self._build_chain()
        sel = self._refresh_sel()
        with _timer.stage("tracking", "dispatchFrameStep"):
            out = fs.frame_step(
                image, chain["desc"], chain["level"], chain["angle"],
                chain["pos"], chain["valid"],
                st.mp_pos, st.mp_desc, st.mp_normal, st.mp_min_dist,
                st.mp_max_dist, st.mp_valid, sel,
                chain["mp_visible"], chain["mp_found"],
                chain["R_last"], chain["t_last"],
                chain["R_prev"], chain["t_prev"], chain["lm"], self.cam,
                ext_cfg=self.cfg.extractor, matcher_cfg=self.cfg.matcher,
                solver_cfg=self.cfg.solver,
                min_track_inliers=tcfg.min_track_inliers,
                has_vel=chain["has_vel"], device=self.device)
        self._pipe.append(dict(out=out, frame_id=self.frame_id,
                               timestamp=timestamp, metrics=metrics))
        self._chain = dict(
            desc=out.desc, level=out.level, angle=out.angle,
            pos=out.next_last_pos, valid=out.next_last_valid,
            R_last=out.R, t_last=out.t,
            R_prev=chain["R_last"], t_prev=chain["t_last"],
            lm=out.lm_matches, mp_visible=out.mp_visible,
            mp_found=out.mp_found, has_vel=bool(tcfg.use_motion_model))
        while len(self._pipe) > depth:
            self._retire_one()

    def _build_chain(self) -> dict:
        """Device handles of the next frame_step, from host state (the
        in-program motion model reproduces the host velocity model: with
        R_prev = vel_R^T R_last, t_prev = vel_R^T (t_last - vel_t),
        R_last R_prev^T == vel_R)."""
        if self.last_frame is None and self._last_stacked is not None:
            self.last_frame = _frame_data(*self._last_stacked)
        lf = self.last_frame
        tcfg = self.cfg.tracker
        st = self.slam_map.state
        dev = self.device
        R_last = np.asarray(self.last_R, np.float32)
        t_last = np.asarray(self.last_t, np.float32)
        has_vel = bool(tcfg.use_motion_model and self.vel_R is not None)
        if has_vel:
            R_prev = self.vel_R.T @ R_last
            t_prev = self.vel_R.T @ (t_last - self.vel_t)
        else:
            R_prev, t_prev = R_last, t_last
        return dict(
            desc=lf.feats.desc, level=lf.feats.level, angle=lf.feats.angle,
            pos=self.last_assoc_pos, valid=self.last_assoc_valid,
            R_last=upload(R_last, dev), t_last=upload(t_last, dev),
            R_prev=upload(np.asarray(R_prev, np.float32), dev),
            t_prev=upload(np.asarray(t_prev, np.float32), dev),
            lm=int(self._prev_localmap_matches),
            mp_visible=st.mp_visible, mp_found=st.mp_found,
            has_vel=has_vel)

    def _refresh_sel(self) -> torch.Tensor:
        """The local-map window (host covisibility voting), recomputed when
        the map changed or every 4 frames; uploaded without a host wait."""
        cap = self.cfg.map.local_ba_max_points
        if (self._sel_cache is None or self._sel_dirty
                or self.frame_id - self._sel_frame >= 4):
            with _timer.stage("tracking", "selectLocalWindow"):
                ids = self._select_local_point_ids(cap)
                sel = np.full(cap, -1, np.int64)
                sel[:len(ids)] = ids
                self._sel_cache = upload(sel, self.device)
            self._sel_frame = self.frame_id
            self._sel_dirty = False
        return self._sel_cache

    def _dispatch_batch(self):
        """Dispatch the buffered frames as one frame_step_scan call."""
        tcfg = self.cfg.tracker
        recs, self._batch_buf = self._batch_buf, []
        if not recs:
            return
        n_real = len(recs)
        st = self.slam_map.state
        chain = self._chain if self._chain is not None else self._build_chain()
        sel = self._refresh_sel()
        with _timer.stage("tracking", "dispatchFrameStep"):
            out = fs.frame_step_scan(
                [r["image"] for r in recs], np.ones(n_real, bool),
                chain["desc"], chain["level"], chain["angle"],
                chain["pos"], chain["valid"],
                st.mp_pos, st.mp_desc, st.mp_normal, st.mp_min_dist,
                st.mp_max_dist, st.mp_valid, sel,
                chain["mp_visible"], chain["mp_found"],
                chain["R_last"], chain["t_last"],
                chain["R_prev"], chain["t_prev"], chain["lm"],
                chain["has_vel"], self.cam,
                ext_cfg=self.cfg.extractor, matcher_cfg=self.cfg.matcher,
                solver_cfg=self.cfg.solver,
                min_track_inliers=tcfg.min_track_inliers,
                device=self.device)
        self._pipe.append(dict(out=out, recs=recs, n_real=n_real))
        if n_real == tcfg.frame_batch:
            self._chain = dict(
                desc=out.last_desc, level=out.last_level,
                angle=out.last_angle,
                pos=out.next_last_pos, valid=out.next_last_valid,
                R_last=out.R_last, t_last=out.t_last,
                R_prev=out.R_prev, t_prev=out.t_prev, lm=out.lm_matches,
                mp_visible=out.mp_visible, mp_found=out.mp_found,
                has_vel=bool(tcfg.use_motion_model))
        else:
            # a partial flush: the next dispatch rebuilds the chain from
            # the host state, as the JAX tracker does
            self._chain = None

    def _retire_batch(self):
        """Fetch one batch's host blobs (one readback) and run the
        per-frame host bookkeeping row by row."""
        rec = self._pipe.pop(0)
        out, recs, n_real = rec["out"], rec["recs"], rec["n_real"]
        tcfg = self.cfg.tracker
        with _timer.stage("tracking", "fetchHostBlob"):
            blobs = out.host_blob.cpu().numpy()
        self.slam_map.state = self.slam_map.state._replace(
            mp_visible=out.mp_visible, mp_found=out.mp_found)

        for b in range(n_real):
            r = recs[b]
            fid, timestamp, metrics = (r["frame_id"], r["timestamp"],
                                       r["metrics"])
            blob = blobs[b]
            pid_global = blob[16:].astype(np.int32)
            Rc = blob[:9].reshape(3, 3)
            tc = blob[9:12]
            n_f2f, n_lm, n_vis, n_inl = (int(x) for x in blob[12:16])
            metrics.update(f2f_matches=n_f2f, localmap_matches=n_lm,
                           n_visible=n_vis, inliers=n_inl)
            self._prev_localmap_matches = n_lm

            if n_inl < self._inlier_floor(fid):
                self.trajectory.append(
                    FrameRecord(fid, timestamp, Rc, tc, False))
                self._chain = None
                self.last_frame = None
                if self.slam_map.n_kf <= tcfg.reset_if_lost_before_kfs:
                    self._reset_map()
                    metrics["event"] = "system_reset"
                else:
                    self.state = TrackState.LOST
                    metrics["event"] = "tracking_lost"
                self._abort_batch_rows(out, recs, b + 1, n_real)
                self._last_stacked = None
                self._abort_pipe()
                return

            self.vel_R = _orthonormalize_np(Rc @ np.asarray(self.last_R).T)
            self.vel_t = tc - self.vel_R @ np.asarray(self.last_t)
            self.last_R, self.last_t = Rc, tc
            self.last_assoc_pid = pid_global
            self.trajectory.append(FrameRecord(fid, timestamp, Rc, tc, True))

            # keyframe decision (NeedNewKeyFrame, Tracking.cc:651-689)
            self.n_ref_tracked = max(self.n_ref_tracked, n_inl)
            if self._need_kf(fid, n_inl):
                self._keyframe_due(n_inl, None, timestamp, pid_global,
                                   metrics, fid, stacked=(out, b))

        # the newest frame's features stay stacked until someone needs them
        self.last_frame = None
        self._last_stacked = (out, n_real - 1)
        self.last_assoc_pos = out.next_last_pos
        self.last_assoc_valid = out.next_last_valid

    def _abort_batch_rows(self, out, recs, start: int, n_real: int):
        """The rows of a batch after a loss: their features go through the
        staged state machine (re-initialization, or the LOST record), and
        rows after a recovery are tracked by the staged WORKING path; every
        frame keeps its record (src/Tracking.cc:181-298)."""
        for b in range(start, n_real):
            r = recs[b]
            self._staged_row(_frame_data(out, b), r["frame_id"],
                             r["timestamp"], r["metrics"])

    def _staged_row(self, fd, frame_id, timestamp, metrics):
        """One in-flight frame through the staged state machine."""
        saved = self.frame_id
        self.frame_id = frame_id
        try:
            if self.state in (TrackState.NOT_INITIALIZED,
                              TrackState.INITIALIZING):
                self._initialize(fd, timestamp, metrics)
            elif self.state == TrackState.LOST:
                self._relocalize(fd, timestamp, metrics)
            elif self.state == TrackState.WORKING:
                self._track(fd, timestamp, metrics)
        finally:
            self.frame_id = saved

    def _drain_pipe(self):
        if self._batch_buf:
            self._dispatch_batch()
        while self._pipe:
            if "recs" in self._pipe[0]:
                self._retire_batch()
            else:
                self._retire_one()

    def _retire_one(self):
        """Fetch the oldest in-flight frame's host blob and run the host
        bookkeeping: trajectory, motion model, loss handling, keyframe
        decision."""
        rec = self._pipe.pop(0)
        out = rec["out"]
        fid, timestamp, metrics = (rec["frame_id"], rec["timestamp"],
                                   rec["metrics"])
        tcfg = self.cfg.tracker
        with _timer.stage("tracking", "fetchHostBlob"):
            blob = out.host_blob.cpu().numpy()          # the one fetch
        pid_global = blob[16:].astype(np.int32)
        Rc = blob[:9].reshape(3, 3)
        tc = blob[9:12]
        n_f2f, n_lm, n_vis, n_inl = (int(x) for x in blob[12:16])
        metrics.update(f2f_matches=n_f2f, localmap_matches=n_lm,
                       n_visible=n_vis, inliers=n_inl)
        self._prev_localmap_matches = n_lm
        self.slam_map.state = self.slam_map.state._replace(
            mp_visible=out.mp_visible, mp_found=out.mp_found)
        fd = _frame_data(out)

        if n_inl < self._inlier_floor(fid):
            self.trajectory.append(FrameRecord(fid, timestamp, Rc, tc, False))
            self._chain = None
            if self.slam_map.n_kf <= tcfg.reset_if_lost_before_kfs:
                self._reset_map()
                metrics["event"] = "system_reset"
            else:
                self.state = TrackState.LOST
                metrics["event"] = "tracking_lost"
            self._abort_pipe()
            return

        self.vel_R = _orthonormalize_np(Rc @ np.asarray(self.last_R).T)
        self.vel_t = tc - self.vel_R @ np.asarray(self.last_t)
        self.last_R, self.last_t = Rc, tc
        self.last_frame = fd
        self.last_assoc_pid = pid_global
        self.last_assoc_valid = out.next_last_valid
        self.last_assoc_pos = out.next_last_pos
        self.trajectory.append(FrameRecord(fid, timestamp, Rc, tc, True))

        # keyframe decision (NeedNewKeyFrame, Tracking.cc:651-689)
        self.n_ref_tracked = max(self.n_ref_tracked, n_inl)
        if self._need_kf(fid, n_inl):
            self._keyframe_due(n_inl, fd, timestamp, pid_global, metrics,
                               fid)
            if self.async_mapper is None:
                # mapping moved landmark pools/poses: rebuild the chain
                self._chain = None

    def _keyframe_due(self, n_inl, fd, timestamp, pid_global, metrics,
                      fid, stacked=None):
        """A retired frame's keyframe decision said yes: insert it, defer
        it to the commit under way, or skip it under backpressure.

        The JAX tracker inserts a keyframe that falls due while it drains
        for a finished job's commit into the map the commit then replaces,
        and the worker's next result drops the job's map (known issue 7,
        ``pipeline/tracker.py:225-232`` with ``:710-724`` there).  Here the
        first such keyframe keeps its frame, pose and features in
        _pending_kf, and the keyframe state moves as if it were inserted
        (last_kf_frame_id, n_ref_tracked), so the drain's later decisions
        are JAX's; _insert_pending puts it into the adopted map, and the
        later due frames of the drain meet a busy worker as they do in
        JAX, which gives JAX's second, forced insertion."""
        if self._adopting and self._pending_kf is None:
            self._pending_kf = dict(
                fd=fd, stacked=stacked, timestamp=timestamp,
                pid=np.asarray(pid_global, np.int32), metrics=metrics,
                fid=fid, R=np.array(self.last_R), t=np.array(self.last_t),
                interrupt=False, queued=False)
            self.n_ref_tracked = int((np.asarray(pid_global) >= 0).sum())
            self.last_kf_frame_id = fid
            return
        if not self._backpressure(n_inl):
            self._create_keyframe(fd, timestamp, pid_global, metrics,
                                  frame_id=fid, stacked=stacked)

    def _insert_pending(self, res: MappingResult, move):
        """After a commit: the keyframe that fell due during its drain goes
        into the adopted map, its pose moved with the map (`move`, from
        _commit_mapping) and its associations remapped and revalidated as
        the last frame's are, and the worker takes it at once.  The drain's
        later due frames asked the worker, now busy with it, to stop its BA
        early or to take a queued keyframe."""
        p, self._pending_kf = self._pending_kf, None
        if p is None:
            return
        n_ref, last_kf = self.n_ref_tracked, self.last_kf_frame_id
        R, t = self.last_R, self.last_t
        self.last_R, self.last_t = (p["R"], p["t"]) if move is None \
            else _moved(p["R"], p["t"], move)
        try:
            self._create_keyframe(p["fd"], p["timestamp"],
                                  self._remap_pid(p["pid"], res),
                                  p["metrics"], frame_id=p["fid"],
                                  stacked=p["stacked"])
        finally:
            self.last_R, self.last_t = R, t
        # the drain's decisions already counted from this keyframe
        self.n_ref_tracked, self.last_kf_frame_id = n_ref, last_kf
        am = self.async_mapper
        if p["interrupt"]:
            am.interrupt_ba.set()
        if p["queued"]:
            am.kf_queued.set()

    def _backpressure(self, n_inl: int) -> bool:
        """A keyframe is due while the mapping worker is busy
        (SetAcceptKeyFrames, src/Tracking.cc:665-685), or while a commit's
        drain holds a deferred keyframe for it: skip it, signalling
        InterruptBA, and if tracking is about to starve, mark a forced
        insertion for the next frame boundary and a queued keyframe for
        the worker.  True = the insertion is skipped."""
        am = self.async_mapper
        if am is None:
            return False
        pending = self._pending_kf
        if pending is None and not am.busy:
            return False
        tcfg = self.cfg.tracker
        starving = n_inl < 2 * tcfg.kf_min_tracked
        if starving:
            self._force_kf = True
        if pending is not None:
            # the worker is idle until the deferred keyframe is submitted,
            # and a submission clears both signals: raise them after it
            pending["interrupt"] |= tcfg.interrupt_ba
            pending["queued"] |= tcfg.interrupt_ba and starving
            return True
        if tcfg.interrupt_ba:
            am.interrupt_ba.set()
            if starving:
                am.kf_queued.set()
        return True

    def _need_kf(self, fid: int, n_inl: int) -> bool:
        """NeedNewKeyFrame (Tracking.cc:651-689), or the pinned schedule."""
        tcfg = self.cfg.tracker
        if self.kf_schedule is not None:
            return fid in self.kf_schedule
        frames_since = fid - self.last_kf_frame_id
        return (
            frames_since >= tcfg.max_frames_between_kf
            or (n_inl < tcfg.kf_min_tracked_ratio
                * max(self.n_ref_tracked, 1)
                and frames_since >= tcfg.min_frames_between_kf)
        ) and n_inl > tcfg.kf_min_inliers_insert

    def _abort_pipe(self):
        """After a loss/reset: route frames dispatched beyond the lost one
        through the staged state machine instead of trusting them."""
        recs, self._pipe = self._pipe, []
        self._chain = None
        for rec in recs:
            out = rec["out"]
            if "recs" in rec:      # a frame_step_scan batch
                self._abort_batch_rows(out, rec["recs"], 0, rec["n_real"])
                continue
            self._staged_row(_frame_data(out), rec["frame_id"],
                             rec["timestamp"], rec["metrics"])

    def _starved_keyframe(self, metrics):
        """Forced keyframe insertion under backpressure (pipeline drained,
        worker flushed): the latest retired frame becomes the keyframe."""
        self._force_kf = False
        self._drain_pipe()
        if self.state != TrackState.WORKING:
            return
        if self.last_frame is None and self._last_stacked is not None:
            self.last_frame = _frame_data(*self._last_stacked)
        res = self.async_mapper.flush()
        if res is not None:
            self._commit_mapping(res, metrics)
        # the drain may already have inserted this very frame
        if (self.trajectory
                and self.last_kf_frame_id == self.trajectory[-1].frame_id):
            return
        self._create_keyframe(
            self.last_frame, self.trajectory[-1].timestamp,
            self.last_assoc_pid, metrics,
            frame_id=self.trajectory[-1].frame_id)
        self._chain = None

    # ------------------------------------------------------------------
    # two-view initialization
    # ------------------------------------------------------------------
    def _initialize(self, fd, timestamp, metrics):
        tcfg = self.cfg.tracker
        n_kp = int(fd.feats.valid.sum())
        if self.state == TrackState.NOT_INITIALIZED:
            if n_kp > tcfg.min_init_keypoints:
                self.init_frame = fd
                self.init_frame_id = self.frame_id
                self.init_timestamp = timestamp
                self.state = TrackState.INITIALIZING
                metrics["event"] = "init_ref_set"
            return
        if n_kp <= tcfg.min_init_keypoints:
            self.state = TrackState.NOT_INITIALIZED
            metrics["event"] = "init_ref_dropped"
            return

        f0, f1 = self.init_frame, fd
        mcfg = self.cfg.matcher
        mm = tk.init_window_match(
            f0.xy_und, f0.feats.desc, f0.feats.level, f0.feats.angle,
            f0.feats.valid,
            f1.xy_und, f1.feats.desc, f1.feats.level, f1.feats.angle,
            f1.feats.valid,
            radius=float(mcfg.window_init), max_dist=mcfg.th_low,
            ratio=mcfg.nn_ratio_init, histo_length=mcfg.histo_length,
            check_orientation=mcfg.check_orientation)
        n_matches = int(mm.valid.sum())
        metrics["init_matches"] = n_matches
        if n_matches < tcfg.min_init_matches:
            self.state = TrackState.NOT_INITIALIZED
            metrics["event"] = "init_too_few_matches"
            return

        icfg = self.cfg.initializer
        if self.init_sampler is not None:
            samples = torch.as_tensor(self.init_sampler(mm.valid))
        else:
            samples = initializer.draw_samples(
                self.generator, mm.valid, icfg.ransac_iterations,
                icfg.sample_size)
        j = torch.clamp(mm.idx, min=0)
        res = initializer.initialize(
            samples.to(self.device), f0.xy_und, f1.xy_und[j], mm.valid,
            upload(np.asarray(self.cfg.camera.K, np.float32), self.device),
            icfg)
        if not bool(res.ok):
            metrics["event"] = "init_geometry_failed"
            return      # keep the reference frame; try the next frame
        f0, f1, mm, res = self._compress_init(f0, f1, mm, res)
        self._create_initial_map(f0, f1, mm, res, timestamp, metrics)

    def _gather_frame_rows(self, fd, rows, row_valid):
        g = upload(np.asarray(rows, np.int64), self.device)
        f = fd.feats
        feats = FrameFeatures(
            xy=f.xy[g], response=f.response[g], angle=f.angle[g],
            level=f.level[g], desc=f.desc[g],
            valid=f.valid[g] & upload(np.asarray(row_valid), self.device))
        return frame_mod.FrameData(feats=feats, xy_und=fd.xy_und[g],
                                   inv_sigma2=fd.inv_sigma2[g],
                                   sigma2=fd.sigma2[g])

    def _compress_init(self, f0, f1, mm, res):
        """Reduce both init frames to max_keypoints rows before map
        creation: triangulation inliers first (aligned at rows 0..m-1 of
        both frames), then highest-response fill."""
        W = self.cfg.extractor.max_keypoints
        if f0.xy_und.shape[0] <= W and f1.xy_und.shape[0] <= W:
            return f0, f1, mm, res
        good = _np(res.good) & _np(mm.valid)
        idx = _np(mm.idx)
        slots0 = np.where(good)[0][:W]
        slots1 = idx[slots0]
        m0 = len(slots0)

        def keep(matched, fd):
            v = _np(fd.feats.valid)
            resp = _np(fd.feats.response)
            rest = np.where(v)[0]
            rest = rest[~np.isin(rest, matched)]
            rest = rest[np.argsort(-resp[rest])]   # as the JAX tracker
            k = np.concatenate([matched, rest])[:W].astype(np.int64)
            kv = np.zeros(W, bool)
            kv[: len(k)] = True
            if len(k) < W:
                k = np.concatenate([k, np.zeros(W - len(k), np.int64)])
            return k, kv

        k0, kv0 = keep(slots0, f0)
        k1, kv1 = keep(slots1, f1)
        nf0 = self._gather_frame_rows(f0, k0, kv0)
        nf1 = self._gather_frame_rows(f1, k1, kv1)

        dev = self.device
        new_idx = np.full(W, -1, np.int64)
        new_idx[:m0] = np.arange(m0)        # matched rows lead in BOTH frames
        new_valid = np.zeros(W, bool)
        new_valid[:m0] = True
        new_pts = np.zeros((W, 3), np.float32)
        new_pts[:m0] = _np(res.points)[slots0]
        new_dist = np.zeros(W, np.int32)
        new_dist[:m0] = _np(mm.dist)[slots0]
        mm2 = mm._replace(idx=upload(new_idx, dev),
                          dist=upload(new_dist, dev),
                          valid=upload(new_valid, dev))
        res2 = res._replace(points=upload(new_pts, dev),
                            good=upload(new_valid, dev),
                            n_good=torch.tensor(m0))
        return nf0, nf1, mm2, res2

    def _create_initial_map(self, f0, f1, mm, res, timestamp, metrics):
        """CreateInitialMap (src/Tracking.cc:394-479): two keyframes, the
        triangulated points, init BA, median-depth normalization."""
        good = _np(res.good)
        slots0 = np.where(good)[0]
        slots1 = _np(mm.idx)[slots0]
        smap = self.slam_map
        N = f0.xy_und.shape[0]
        dev = self.device

        obs0 = np.full(N, -1, np.int32)
        obs1 = np.full(N, -1, np.int32)
        kf0 = smap.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            f0.xy_und, f0.feats.level, f0.feats.angle, f0.feats.desc,
            f0.feats.valid, obs0, self.init_frame_id, self.init_timestamp,
            parent=-1)
        kf1 = smap.add_keyframe(
            res.R, res.t, f1.xy_und, f1.feats.level, f1.feats.angle,
            f1.feats.desc, f1.feats.valid, obs1, self.frame_id, timestamp,
            parent=kf0)

        ids = smap.add_points(
            res.points, f0.feats.desc, torch.zeros((N, 3), device=dev),
            torch.zeros(N, device=dev),
            torch.full((N,), float("inf"), device=dev), kf1, good)
        obs0[good] = ids[good]
        obs1h = np.full(N, -1, np.int32)
        obs1h[slots1] = ids[slots0]
        smap.set_observations(kf0, np.arange(N), obs0)
        smap.set_observations(kf1, np.arange(N), obs1h)

        # init BA (20 iterations, Tracking.cc:448)
        self.local_mapper.global_ba(smap)

        # median-depth normalization (Tracking.cc:451-475), on the mirrors
        pos = smap.host["mp_pos"][: smap.n_mp]
        valid = smap.mp_valid_np[: smap.n_mp]
        t1 = smap.host["kf_t"][kf1].copy()
        z0 = pos[valid][:, 2]            # kf0 at identity: depth = z
        if (len(z0) < self.cfg.tracker.min_init_matches
                or np.median(z0) <= 0):
            metrics["event"] = "init_rejected_after_ba"
            self._reset_map()
            return
        scale = 1.0 / float(np.median(z0))
        st = smap.state
        st.mp_pos.mul_(scale)
        t1s = (t1 * scale).astype(np.float32)
        st.kf_t[kf1] = upload(t1s, dev)
        # mirror the normalization (float32 multiply is bitwise identical)
        smap.host["mp_pos"] *= np.float32(scale)
        smap.host["kf_t"][kf1] = t1s

        self.local_mapper.refresh_point_stats(smap)

        # place recognition: the vocabulary (trained on the init frames'
        # descriptors only when no vocabulary file is configured or
        # shipped) and the two bootstrap keyframes
        lc = self.loop_closer
        if lc is not None:
            lc.ensure_vocabulary(lambda: np.concatenate([
                _np(f.feats.desc)[_np(f.feats.valid)] for f in (f0, f1)]))
            lc.add_keyframe(smap, kf0)
            lc.add_keyframe(smap, kf1)

        self.last_R = smap.host["kf_R"][kf1].copy()
        self.last_t = smap.host["kf_t"][kf1].copy()
        self.last_frame = f1
        pid = smap.obs_np[kf1].copy()
        self._set_last_assoc(pid)
        self.ref_kf = kf1
        self.n_ref_tracked = int((pid >= 0).sum())
        self.last_kf_frame_id = self.frame_id
        self.vel_R, self.vel_t = None, None
        self.state = TrackState.WORKING
        metrics["event"] = "map_initialized"
        metrics["n_init_points"] = int(good.sum())
        self.trajectory.append(FrameRecord(
            self.init_frame_id, self.init_timestamp, np.eye(3), np.zeros(3),
            True))
        self.trajectory.append(FrameRecord(
            self.frame_id, timestamp, self.last_R.copy(),
            self.last_t.copy(), True))

    def _set_last_assoc(self, pid: np.ndarray):
        """The last frame's per-slot landmark ids, validity and positions."""
        self.last_assoc_pid = pid
        p = upload(pid.astype(np.int64), self.device)
        self.last_assoc_valid = p >= 0
        self.last_assoc_pos = self.slam_map.state.mp_pos[torch.clamp(p,
                                                                     min=0)]

    def _reset_map(self):
        """Full system reset (src/Tracking.cc:1052-1089).  In-flight
        mapping work is drained first; its result dies with the old map
        (a worker error is raised, not dropped)."""
        if self.async_mapper is not None:
            self.async_mapper.flush()
        self.slam_map = mapstore.SlamMap.create(
            self.cfg.map, self.cfg.extractor.max_keypoints,
            device=self.device)
        self.state = TrackState.NOT_INITIALIZED
        self.ref_kf = -1
        self.vel_R = None
        self.last_kf_frame_id = -10**9
        self.last_reloc_frame_id = -10**9
        self.n_ref_tracked = 0
        self._prev_localmap_matches = 0
        self._sel_cache = None
        self._sel_dirty = True
        self._pipe = []
        self._chain = None
        self._force_kf = False
        self._pending_kf = None
        self._batch_buf = []
        self._last_stacked = None
        if self.loop_closer is not None:
            self.loop_closer.reset()

    # ------------------------------------------------------------------
    # staged WORKING path (pre-extracted features)
    # ------------------------------------------------------------------
    def _track(self, fd, timestamp, metrics):
        tcfg = self.cfg.tracker
        dev = self.device
        # after batched tracking the last frame may live only as a row of
        # a stacked output
        if self.last_frame is None and self._last_stacked is not None:
            self.last_frame = _frame_data(*self._last_stacked)
        if tcfg.use_motion_model and self.vel_R is not None:
            R_pred = self.vel_R @ self.last_R
            t_pred = self.vel_R @ self.last_t + self.vel_t
        else:
            R_pred, t_pred = self.last_R, self.last_t
        lf = self.last_frame
        mp = self._local_points()
        R_fin, t_fin, assoc2, inliers_mask, visible_mask, stats = \
            tk.tracking_megastep(
                fd.xy_und, fd.feats.desc, fd.feats.level, fd.feats.angle,
                fd.feats.valid, fd.inv_sigma2,
                self.last_assoc_pos, lf.feats.desc, lf.feats.level,
                lf.feats.angle, self.last_assoc_valid,
                mp["pos"], mp["desc"], mp["normal"], mp["min_d"],
                mp["max_d"], mp["valid"],
                upload(np.asarray(R_pred, np.float32), dev),
                upload(np.asarray(t_pred, np.float32), dev),
                self.cam, self.cfg.solver,
                min_track_inliers=tcfg.min_track_inliers,
                prev_localmap_matches=self._prev_localmap_matches,
                scale_factor=self.cfg.extractor.scale_factor,
                n_levels=self.cfg.extractor.n_levels,
                matcher_cfg=self.cfg.matcher)
        s = torch.stack([stats["f2f_matches"], stats["localmap_matches"],
                         stats["n_visible"], stats["n_inliers"]]).cpu()
        n_f2f, n_lm, n_vis, n_inl = (int(x) for x in s)
        metrics["f2f_matches"] = n_f2f
        self._prev_localmap_matches = n_lm
        metrics["localmap_matches"] = n_lm
        metrics["n_visible"] = n_vis
        metrics["inliers"] = n_inl
        Rc, tc = _np(R_fin), _np(t_fin)

        if n_inl < self._inlier_floor(self.frame_id):
            self.trajectory.append(FrameRecord(self.frame_id, timestamp,
                                               Rc, tc, False))
            if self.slam_map.n_kf <= tcfg.reset_if_lost_before_kfs:
                self._reset_map()
                metrics["event"] = "system_reset"
            else:
                self.state = TrackState.LOST
                metrics["event"] = "tracking_lost"
            return

        # visible/found counts for culling (src/MapPoint.cc:167-183)
        pid_local = _np(assoc2.point_idx)
        inl = _np(inliers_mask)
        matched = _np(assoc2.valid)
        self._bump_point_stats(mp["ids"], pid_local, matched, inl,
                               _np(visible_mask))

        Rl, tl = np.asarray(self.last_R), np.asarray(self.last_t)
        self.vel_R = _np(se3.orthonormalize(torch.from_numpy(
            np.ascontiguousarray(Rc @ Rl.T, np.float32))))
        self.vel_t = tc - self.vel_R @ tl
        self.last_R, self.last_t = Rc, tc
        self.last_frame = fd
        pid_global = np.where(matched & inl, mp["ids"][pid_local],
                              -1).astype(np.int32)
        self._set_last_assoc(pid_global)
        self.trajectory.append(FrameRecord(self.frame_id, timestamp, Rc, tc,
                                           True))
        self.n_ref_tracked = max(self.n_ref_tracked, n_inl)
        if not self._need_kf(self.frame_id, n_inl):
            return
        if self._adopting:
            # a drained frame after a loss and a relocalisation
            self._keyframe_due(n_inl, fd, timestamp, pid_global, metrics,
                               self.frame_id)
            return
        am = self.async_mapper
        if am is not None and am.busy:
            # backpressure; a starving tracker drains the worker and
            # inserts at once (the staged path has no pipeline to wait for)
            if tcfg.interrupt_ba:
                am.interrupt_ba.set()
            if n_inl < 2 * tcfg.kf_min_tracked:
                if tcfg.interrupt_ba:
                    am.kf_queued.set()
                res = am.flush()
                if res is not None:
                    self._commit_mapping(res, metrics)
                self._create_keyframe(fd, timestamp, self.last_assoc_pid,
                                      metrics)
        else:
            self._create_keyframe(fd, timestamp, pid_global, metrics)

    def _relocalize(self, fd, timestamp, metrics):
        """BoW relocalisation (src/Tracking.cc:867-1036): candidate
        keyframes from the database, descriptor matching against their
        landmarks, batched EPnP RANSAC, pose refinement over its inliers,
        local-map re-acquisition at the recovered pose.  In-flight mapping
        work is committed first: it writes the database."""
        metrics["event"] = "lost"
        if self.async_mapper is not None:
            res = self.async_mapper.flush()
            if res is not None:
                self._commit_mapping(res, metrics)
        lc = self.loop_closer
        smap = self.slam_map
        if lc is None or lc.voc is None or smap.n_kf == 0:
            self._record_lost(timestamp)
            return
        with _timer.stage("tracking", "relocBow"):
            # the frame's descriptors and validity in one fetch
            packed = torch.cat([fd.feats.desc, fd.feats.valid[:, None].to(
                torch.int32)], dim=1).cpu().numpy()
            bow = voc_mod.transform_np(lc.voc, packed[:, :8],
                                       packed[:, 8] != 0)
        with _timer.stage("tracking", "relocCandidates"):
            covis = lc._covis_np(smap).astype(np.float64)
            lc.ensure_capacity(smap.cfg.max_keyframes)
            cands = db_mod.detect_candidates(
                lc.db, bow, np.zeros(len(lc.db.has_row), bool), covis,
                min_score=None)
            # the three most recent live keyframes join a weak BoW
            # shortlist: a loss usually happens near the last tracked
            # position (the JAX tracker's choice; ForceRelocalisation,
            # src/Tracking.cc:867-884, relocalizes against that window)
            live = np.where(smap.kf_valid_np)[0]
            by_recency = live[np.argsort(
                -np.asarray(smap.kf_frame_id)[live])]
            known = set(int(c) for c in cands)
            recent = [k for k in by_recency if k not in known][:3]
            cands = np.concatenate([np.asarray(cands, np.int64),
                                    np.asarray(recent, np.int64)])
        metrics["reloc_candidates"] = len(cands)

        for cand in cands[:8]:
            if self._reloc_candidate(fd, timestamp, metrics, int(cand)):
                return
        # every attempted frame leaves a record, at the last known pose
        self._record_lost(timestamp)

    def _record_lost(self, timestamp):
        """An untracked record at the last known pose (a live consumer sees
        an explicit untracked pose, not a gap)."""
        if self.last_R is not None:
            self.trajectory.append(FrameRecord(
                self.frame_id, timestamp, np.asarray(self.last_R),
                np.asarray(self.last_t), False))

    def _pnp_samples(self, pvalid: np.ndarray, n_samples: int,
                     min_set: int) -> torch.Tensor:
        if self.pnp_sampler is not None:
            return torch.as_tensor(np.asarray(
                self.pnp_sampler(pvalid, n_samples, min_set), np.int64))
        return pnp.draw_samples(self.generator, pvalid, n_samples, min_set)

    def _reloc_candidate(self, fd, timestamp, metrics, cand: int) -> bool:
        """One relocalisation attempt against keyframe `cand`; True when it
        recovered the frame (state, pose, associations and record set)."""
        smap = self.slam_map
        st = smap.state
        dev = self.device
        mcfg, scfg, tcfg = self.cfg.matcher, self.cfg.solver, self.cfg.tracker
        obs = smap.obs_np[cand]
        if (obs >= 0).sum() < 15:
            return False
        with _timer.stage("tracking", "relocMatch"):
            # frame keypoints (rows) against the candidate's keypoints
            dist = match_ops.hamming_matrix(fd.feats.desc, st.kf_desc[cand])
            mask = match_ops.valid_mask(fd.feats.valid, upload(obs >= 0, dev))
            mm = match_ops.match_nn(match_ops.apply_masks(dist, mask),
                                    max_dist=mcfg.th_low, ratio=0.75)
            if mcfg.check_orientation:
                # SearchByBoW's rotation histogram (the reference's reloc
                # matcher is ORBmatcher(0.75, true))
                keep = match_ops.rotation_consistency(
                    fd.feats.angle, st.kf_angle[cand], mm,
                    histo_length=mcfg.histo_length)
                mm = match_ops.Matches(
                    idx=torch.where(keep, mm.idx, torch.full_like(mm.idx, -1)),
                    dist=mm.dist, valid=keep)
            mm = match_ops.resolve_duplicates(mm, obs.shape[0])
            h = torch.stack([mm.idx, mm.valid.to(torch.int64)]).cpu().numpy()
        m_idx, m_valid = h[0], h[1] != 0
        n_matches = int(m_valid.sum())
        metrics["reloc_matches"] = n_matches
        if n_matches < 15:
            return False

        pid = obs[np.clip(m_idx, 0, None)]
        pvalid = m_valid & (pid >= 0)
        X = st.mp_pos[upload(np.clip(pid, 0, None).astype(np.int64), dev)]
        pvalid_d = upload(pvalid, dev)
        # the RANSAC budget: the JAX tracker's formula (tracker.py:
        # 1368-1378) floors the analytic iteration count at pnp_max_iters
        # and caps it there, so it always resolves to pnp_max_iters rounded
        # up to a power of two (512 at the default 300; ROADMAP Queue 3,
        # known issue 4)
        n_samp = 1 << (scfg.pnp_max_iters - 1).bit_length()
        with _timer.stage("tracking", "relocPnP"):
            res = pnp.pnp_ransac(
                X, fd.xy_und, fd.inv_sigma2, pvalid_d,
                upload(np.asarray(self.cfg.camera.K, np.float32), dev),
                n_samples=n_samp, min_set=scfg.pnp_min_set,
                chi2_th=scfg.pnp_th2, min_inliers=scfg.pnp_min_inliers,
                samples=self._pnp_samples(pvalid, n_samp, scfg.pnp_min_set))
            ok_inl = torch.cat([res.ok[None], res.inliers]).cpu().numpy()
        if not ok_inl[0]:
            return False
        inl_pnp = ok_inl[1:]
        with _timer.stage("tracking", "relocPoseLM"):
            # refined over the RANSAC inliers only (Tracking.cc:958-980
            # nulls the other map points before PoseOptimization)
            r1 = pose_opt.optimize_pose(
                res.R, res.t, X, fd.xy_und, fd.inv_sigma2,
                pvalid_d & res.inliers, self.cam, scfg)
            n1 = int(r1.n_inliers)
        if n1 < scfg.pnp_min_inliers:
            return False

        with _timer.stage("tracking", "relocLocalMap"):
            # local-map re-acquisition at the recovered pose, voted by the
            # PnP inlier landmarks (the stale pre-loss associations would
            # pick the wrong keyframe neighbourhood)
            mp = self._local_points(seed_pids=pid[inl_pnp & pvalid])

            def match_round(R, t, th, max_dist):
                assoc, _ = tk.match_local_map(
                    fd.xy_und, fd.feats.desc, fd.feats.level,
                    fd.feats.angle, fd.feats.valid,
                    mp["pos"], mp["desc"], mp["normal"], mp["min_d"],
                    mp["max_d"], mp["valid"], R, t, self.cam,
                    th=float(th), max_dist=max_dist,
                    ratio=mcfg.nn_ratio_localmap,
                    n_levels=self.cfg.extractor.n_levels,
                    radius_tight=mcfg.radius_view_cos_tight,
                    radius_wide=mcfg.radius_view_cos_wide)
                r = pose_opt.optimize_pose(
                    R, t, assoc.pos, fd.xy_und, fd.inv_sigma2,
                    assoc.valid, self.cam, scfg)
                return assoc, r, int(r.n_inliers)

            # escalation rounds (Tracking.cc:984-1021): a wide projection
            # search first; in the 30..50 band, a narrow search at the
            # refined pose with a tighter descriptor gate decides
            need = tcfg.min_localmap_inliers_reloc
            assoc2, r2, n_inl = match_round(
                r1.R, r1.t, mcfg.reloc_proj_th_wide, mcfg.th_high)
            if tcfg.min_localmap_inliers <= n_inl < need:
                assoc2, r2, n_inl = match_round(
                    r2.R, r2.t, mcfg.reloc_proj_th_narrow,
                    mcfg.reloc_orb_dist)
        metrics["reloc_inliers"] = n_inl
        if n_inl < need:
            return False

        # recovered: the pose, the associations and their validity in one
        # fetch
        R_cur = se3.orthonormalize(r2.R)
        N = fd.xy_und.shape[0]
        h = torch.cat([
            R_cur.reshape(-1), r2.t,
            assoc2.point_idx.to(torch.float32),
            (assoc2.valid & r2.inliers).to(torch.float32)]).cpu().numpy()
        Rc, tc = h[:9].reshape(3, 3).copy(), h[9:12].copy()
        pid_local = h[12:12 + N].astype(np.int64)
        keep = h[12 + N:] != 0
        pid_global = np.where(keep, mp["ids"][pid_local], -1).astype(np.int32)
        self.last_R, self.last_t = Rc, tc
        self.last_frame = fd
        self._set_last_assoc(pid_global)
        self.vel_R, self.vel_t = None, None
        self._prev_localmap_matches = n_inl
        self._chain = None
        self.state = TrackState.WORKING
        self.last_reloc_frame_id = self.frame_id
        metrics["event"] = "relocalized"
        metrics["reloc_kf"] = cand
        self.trajectory.append(FrameRecord(self.frame_id, timestamp, Rc, tc,
                                           True))
        return True

    # ------------------------------------------------------------------
    def _local_points(self, seed_pids: Optional[np.ndarray] = None) -> dict:
        """Covisibility-limited local map (src/Tracking.cc:754-865)."""
        cap = self.cfg.map.local_ba_max_points
        st = self.slam_map.state
        ids = self._select_local_point_ids(cap, seed_pids)
        pad = cap - len(ids)
        sel = upload(np.concatenate([ids, np.zeros(pad, np.int64)]).astype(
            np.int64), self.device)
        valid = np.concatenate([np.ones(len(ids), bool),
                                np.zeros(pad, bool)])
        return {
            "ids": np.concatenate([ids, np.full(pad, -1)]).astype(np.int32),
            "pos": st.mp_pos[sel], "desc": st.mp_desc[sel],
            "normal": st.mp_normal[sel], "min_d": st.mp_min_dist[sel],
            "max_d": st.mp_max_dist[sel],
            "valid": upload(valid, self.device)}

    def _host_kf_obs(self) -> np.ndarray:
        return self.slam_map.obs_np

    def _host_mp_valid(self) -> np.ndarray:
        return self.slam_map.mp_valid_np

    def _select_local_point_ids(self, cap: int,
                                seed_pids: Optional[np.ndarray] = None
                                ) -> np.ndarray:
        """Keyframes voted by the last frame's tracked landmarks, capped at
        max_local_keyframes; the local points are their observations."""
        n_kf = self.slam_map.n_kf
        mp_valid = self._host_mp_valid()
        tracked = seed_pids if seed_pids is not None else self.last_assoc_pid
        if tracked is None or n_kf == 0:
            return np.where(mp_valid)[0][:cap]
        tracked = tracked[tracked >= 0]
        if len(tracked) == 0:
            return np.where(mp_valid)[0][:cap]
        P = self.cfg.map.max_points
        seen = np.zeros(P + 1, bool)
        seen[tracked] = True
        obs = self._host_kf_obs()[:n_kf]
        votes = native.vote_keyframes(obs, seen)
        order = np.argsort(-votes)
        local_kfs = [int(k) for k in
                     order[: self.cfg.tracker.max_local_keyframes]
                     if votes[k] > 0]
        if not local_kfs:
            return np.where(mp_valid)[0][:cap]
        sel_obs = obs[local_kfs]
        ids = np.unique(sel_obs[sel_obs >= 0])
        ids = ids[mp_valid[ids]]
        return ids[:cap]

    def _bump_point_stats(self, ids, pid_local, matched, inlier, visible):
        st = self.slam_map.state
        vis_ids = ids[visible]
        found_ids = ids[pid_local[matched & inlier]]
        vis_ids = vis_ids[vis_ids >= 0].astype(np.int64)
        found_ids = found_ids[found_ids >= 0].astype(np.int64)
        dev = self.device
        self.slam_map.state = st._replace(
            mp_visible=st.mp_visible.index_add(
                0, upload(vis_ids, dev),
                torch.ones(len(vis_ids), dtype=torch.int32, device=dev)),
            mp_found=st.mp_found.index_add(
                0, upload(found_ids, dev),
                torch.ones(len(found_ids), dtype=torch.int32, device=dev)))

    def _create_keyframe(self, fd, timestamp, pid_global, metrics,
                         frame_id: Optional[int] = None, stacked=None):
        if frame_id is None:
            frame_id = self.frame_id
        smap = self.slam_map
        # keyframe-pool compaction at the insertion boundary, before the
        # old ref_kf id becomes the new keyframe's parent
        if smap.n_kf >= smap.cfg.max_keyframes:
            smap.last_kf_compaction_lut = None
            freed = smap.compact_keyframes()
            if freed > 0:
                lut = smap.last_kf_compaction_lut
                smap.last_kf_compaction_lut = None
                if self.ref_kf >= 0:
                    self.ref_kf = int(lut[self.ref_kf])
                self._sel_dirty = True
                if self.loop_closer is not None:
                    self.loop_closer.remap_keyframes(lut)
                metrics["kf_compaction_freed"] = freed

        obs = np.asarray(pid_global, np.int32)
        with _timer.stage("tracking", "insertKeyframe"):
            if stacked is not None:      # row b of a frame_step_scan output
                out, b = stacked
                kf = smap.add_keyframe(
                    self.last_R, self.last_t, out.xy_und, out.level,
                    out.angle, out.desc, out.kp_valid, obs, frame_id,
                    timestamp, parent=self.ref_kf, batch_index=b)
            else:
                kf = smap.add_keyframe(
                    self.last_R, self.last_t, fd.xy_und, fd.feats.level,
                    fd.feats.angle, fd.feats.desc, fd.feats.valid, obs,
                    frame_id, timestamp, parent=self.ref_kf)
        self.ref_kf = kf
        self.n_ref_tracked = int((pid_global >= 0).sum())
        self.last_kf_frame_id = frame_id
        self._sel_dirty = True
        metrics["event"] = "keyframe_inserted"
        metrics["kf_id"] = kf

        if self.async_mapper is not None:
            # the worker maps a snapshot; the result is committed at a
            # later frame boundary
            with _timer.stage("tracking", "submitMapping"):
                self.async_mapper.submit(smap, kf)
            return

        # keyframe-rate map building (synchronous)
        metrics.update(self.local_mapper.process_keyframe(smap, kf))

        lc = self.loop_closer
        if lc is not None and lc.db is not None:
            # culled keyframes leave the place-recognition database
            for ck in (self.local_mapper.last_culled_kfs or []):
                lc.db = lc.db.remove(ck)
                lc.kf_bow.pop(ck, None)
        if lc is not None and lc.voc is not None:
            # loop detection, check and correction at keyframe rate
            lc_metrics = lc.process_keyframe(smap, kf)
            metrics.update(lc_metrics)
            if lc_metrics.get("loop_closed"):
                # the whole map moved: refresh the landmark statistics and
                # re-anchor tracking without the motion model
                self.local_mapper.refresh_point_stats(smap)
                self.vel_R, self.vel_t = None, None

        # the keyframe pose may have moved in local BA (mirrors are exact)
        self.last_R = smap.host["kf_R"][kf].copy()
        self.last_t = smap.host["kf_t"][kf].copy()
        self._set_last_assoc(smap.obs_np[kf].copy())

    # ------------------------------------------------------------------
    def keyframe_trajectory(self):
        """TUM-format keyframe trajectory (src/main.cc:160-185):
        camera-to-world poses of the live keyframes."""
        self.finish()
        smap = self.slam_map
        rows = []
        for k in range(smap.n_kf):
            if not smap.kf_valid_np[k]:
                continue
            R = smap.host["kf_R"][k]
            t = smap.host["kf_t"][k]
            Rwc = R.T
            twc = -R.T @ t
            q = se3.to_quaternion(torch.from_numpy(
                np.ascontiguousarray(Rwc))).numpy()
            rows.append((self.kf_timestamp(k), twc, q))
        return rows

    def kf_timestamp(self, k):
        return float(self.slam_map.kf_timestamp[k])
