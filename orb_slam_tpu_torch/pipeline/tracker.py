"""Tracking state machine, synchronous single-frame (port of
``orb_slam_tpu.pipeline.tracker``).

The host orchestrator of the per-frame pipeline (the Tracking thread of
src/Tracking.cc): states NOT_INITIALIZED -> INITIALIZING -> WORKING <->
LOST (Tracking.h:57-64).  Frames before the map exists are extracted at
init_features_mult x the feature budget and go through two-view
initialization; WORKING frames run ``frame_step`` (extraction + matching +
pose LM + landmark counts, kernels 1 and 2 inside) and are retired at once
(pipeline depth 0: synchronous keyframe mapping mutates the landmark
tables); each keyframe runs the local mapper synchronously.

Poses and associations the host needs live in numpy (from the per-frame
host blob and the map's host mirrors), so a WORKING frame reads the card
only at frame_step's two fallback decisions and at the blob fetch.

Not in this slice: async mapping and frame_batch > 1 (``Tracker.create``
raises NotImplementedError), relocalisation (a LOST frame is recorded
untracked, as the JAX tracker does without a loop closer), loop closing and
checkpoint resume.
"""
from __future__ import annotations

import enum
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
from ..solvers import initializer
from ..utils.timing import GLOBAL_TIMER as _timer
from .. import native
from . import frame as frame_mod
from . import frame_step as fs
from . import track_kernels as tk
from .local_mapper import LocalMapper


def _orthonormalize_np(R: np.ndarray) -> np.ndarray:
    """Host-side SO(3) projection (SVD) of the motion-model velocity."""
    u, _, vt = np.linalg.svd(R.astype(np.float64))
    s = np.sign(np.linalg.det(u @ vt))
    return (u @ np.diag([1.0, 1.0, s]) @ vt).astype(np.float32)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


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
    # pinned keyframe schedule (replay harness): when set, NeedNewKeyFrame
    # is exactly "frame_id in this set"
    kf_schedule: Optional[set] = None
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
    # RANSAC samples of two-view initialization: drawn from this CPU
    # generator (seeded by cfg.seed), unless init_sampler is set —
    # init_sampler(valid [N] bool tensor) -> [S, sample_size] indices
    generator: Optional[torch.Generator] = None
    init_sampler: Optional[Callable] = None

    @staticmethod
    def create(cfg: SystemConfig, device=None) -> "Tracker":
        tcfg = cfg.tracker
        if tcfg.async_mapping:
            raise NotImplementedError(
                "async_mapping=True: the async mapper (pipeline/"
                "async_mapper.py) comes with the frame_step_scan slice of "
                "the port; run with async_mapping=False")
        if tcfg.frame_batch > 1:
            raise NotImplementedError(
                f"frame_batch={tcfg.frame_batch}: batched dispatch "
                "(frame_step_scan) comes with the async-mapper slice of the "
                "port; run with frame_batch=1")
        if cfg.solver.ba_layout != "flat":
            raise NotImplementedError(
                f"ba_layout={cfg.solver.ba_layout!r}: the GRID layout comes "
                "with a later slice of the port")
        dev = resolve_device(device)
        if dev.type == "cuda":
            # the card's path runs the compiled host graph ops, never the
            # numpy versions behind a failed build
            native.require_compiled()
        cam = cam_mod.make_camera(cfg.camera, device=dev)
        smap = mapstore.SlamMap.create(cfg.map, cfg.extractor.max_keypoints,
                                       device=dev)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(cfg.seed)
        return Tracker(cfg=cfg, cam=cam, slam_map=smap,
                       local_mapper=LocalMapper(cfg=cfg, cam=cam),
                       device=dev, generator=gen)

    # ------------------------------------------------------------------
    def process(self, feats: FrameFeatures, timestamp: float) -> dict:
        """Track one frame from pre-extracted features (staged path)."""
        self._drain_pipe()
        self._chain = None
        fd = frame_mod.build_frame(feats, self.cam, self.cfg.extractor)
        metrics = {"frame_id": self.frame_id, "state": self.state.name,
                   "n_kp": int(feats.valid.sum())}
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
        frame_step; other states extract first and take the staged path."""
        if self.state == TrackState.WORKING:
            metrics = {"frame_id": self.frame_id, "state": self.state.name}
            with _timer.stage("tracking", "trackFused"):
                self._track_fused(image, timestamp, metrics)
            self.frame_id += 1
            metrics["state_after"] = self.state.name
            metrics["n_map_points"] = self.slam_map.n_mp
            metrics["n_keyframes"] = self.slam_map.n_kf
            return metrics
        feats = self.extract(image)
        return self.process(feats, timestamp)

    def finish(self):
        """Retire in-flight frames (before exporting the trajectory/map)."""
        self._drain_pipe()

    def shutdown(self):
        self.finish()

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
        # depth 0: synchronous keyframe mapping mutates the landmark pools
        while self._pipe:
            self._retire_one()

    def _build_chain(self) -> dict:
        """Device handles of the next frame_step, from host state (the
        in-program motion model reproduces the host velocity model: with
        R_prev = vel_R^T R_last, t_prev = vel_R^T (t_last - vel_t),
        R_last R_prev^T == vel_R)."""
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

    def _drain_pipe(self):
        while self._pipe:
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
        fd = frame_mod.FrameData(
            feats=FrameFeatures(xy=out.xy, response=out.response,
                                angle=out.angle, level=out.level,
                                desc=out.desc, valid=out.kp_valid),
            xy_und=out.xy_und, inv_sigma2=out.inv_sigma2, sigma2=out.sigma2)

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
            self._create_keyframe(fd, timestamp, pid_global, metrics,
                                  frame_id=fid)
            # mapping moved landmark pools/poses: rebuild the chain
            self._chain = None

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
            fd = frame_mod.FrameData(
                feats=FrameFeatures(xy=out.xy, response=out.response,
                                    angle=out.angle, level=out.level,
                                    desc=out.desc, valid=out.kp_valid),
                xy_und=out.xy_und, inv_sigma2=out.inv_sigma2,
                sigma2=out.sigma2)
            saved = self.frame_id
            self.frame_id = rec["frame_id"]
            try:
                if self.state in (TrackState.NOT_INITIALIZED,
                                  TrackState.INITIALIZING):
                    self._initialize(fd, rec["timestamp"], rec["metrics"])
                elif self.state == TrackState.LOST:
                    self._relocalize(fd, rec["timestamp"], rec["metrics"])
                elif self.state == TrackState.WORKING:
                    self._track(fd, rec["timestamp"], rec["metrics"])
            finally:
                self.frame_id = saved

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
        """Full system reset (src/Tracking.cc:1052-1089)."""
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

    # ------------------------------------------------------------------
    # staged WORKING path (pre-extracted features)
    # ------------------------------------------------------------------
    def _track(self, fd, timestamp, metrics):
        tcfg = self.cfg.tracker
        dev = self.device
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
        if self._need_kf(self.frame_id, n_inl):
            self._create_keyframe(fd, timestamp, pid_global, metrics)

    def _relocalize(self, fd, timestamp, metrics):
        """Without place recognition (it comes with the relocalisation
        slice) a LOST frame is recorded untracked at the last pose, as the
        JAX tracker does without a loop closer."""
        metrics["event"] = "lost"
        if self.last_R is not None:
            self.trajectory.append(FrameRecord(
                self.frame_id, timestamp, np.asarray(self.last_R),
                np.asarray(self.last_t), False))

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
                         frame_id: Optional[int] = None):
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
                metrics["kf_compaction_freed"] = freed

        kf = smap.add_keyframe(
            self.last_R, self.last_t, fd.xy_und, fd.feats.level,
            fd.feats.angle, fd.feats.desc, fd.feats.valid,
            np.asarray(pid_global, np.int32), frame_id, timestamp,
            parent=self.ref_kf)
        self.ref_kf = kf
        self.n_ref_tracked = int((pid_global >= 0).sum())
        self.last_kf_frame_id = frame_id
        self._sel_dirty = True
        metrics["event"] = "keyframe_inserted"
        metrics["kf_id"] = kf

        # keyframe-rate map building (synchronous)
        metrics.update(self.local_mapper.process_keyframe(smap, kf))

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
