"""Flat SoA map state (port of ``orb_slam_tpu.mapping.mapstore``).

Fixed-capacity tensors with validity masks replace the reference's
pointer graph (Map / KeyFrame / MapPoint, src/Map.cc, src/KeyFrame.cc,
src/MapPoint.cc); the observation graph is a dense per-keyframe slot table
(keypoint slot -> map-point id), and covisibility is derived from it on
demand.  Host scalars (n_kf, n_mp) drive allocation; the device tensors
hold the state; the spanning tree and loop edges live on the host.

Unlike the JAX package, tables are updated in place with unique-index
``index_put_`` writes (the add-only scatter of ``ops/scatter.py`` was a
relay workaround).  Descriptors are int32 views of the uint32 words.

The host mirrors (``obs_np``, ``kf_valid_np``, ``mp_valid_np`` and
``host{...}``) are maintained incrementally from the values each update
writes, so keyframe-rate graph logic never reads the device tables back;
``tests/test_torch_mapstore.py`` holds each mirror bitwise equal to its
table.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..config import MapConfig
from ..device import resolve_device, upload


class MapState(NamedTuple):
    """Device-resident SoA map."""

    # keyframes
    kf_valid: torch.Tensor     # [K] bool
    kf_R: torch.Tensor         # [K, 3, 3] world->cam
    kf_t: torch.Tensor         # [K, 3]
    kf_xy: torch.Tensor        # [K, N, 2] undistorted keypoint pixels
    kf_level: torch.Tensor     # [K, N] int32
    kf_angle: torch.Tensor     # [K, N] float32
    kf_desc: torch.Tensor      # [K, N, 8] int32 (uint32 bits)
    kf_kp_valid: torch.Tensor  # [K, N] bool
    kf_obs: torch.Tensor       # [K, N] int32 map-point id per slot, -1 none
    # map points
    mp_valid: torch.Tensor     # [P] bool
    mp_pos: torch.Tensor       # [P, 3]
    mp_desc: torch.Tensor      # [P, 8] int32 representative descriptor
    mp_normal: torch.Tensor    # [P, 3] mean viewing direction
    mp_min_dist: torch.Tensor  # [P] scale-invariance band
    mp_max_dist: torch.Tensor  # [P]
    mp_ref_kf: torch.Tensor    # [P] int32
    mp_first_kf: torch.Tensor  # [P] int32 (culling window anchor)
    mp_found: torch.Tensor     # [P] int32 tracking found count
    mp_visible: torch.Tensor   # [P] int32 tracking visible count


# the tables with a host mirror in SlamMap.host
_HOST = ("kf_R", "kf_t", "kf_xy", "kf_level", "kf_desc", "kf_kp_valid",
         "mp_pos", "mp_first_kf", "mp_found", "mp_visible")


def _ids(idx, device) -> torch.Tensor:
    return upload(np.asarray(idx, np.int64), device)


@dataclasses.dataclass
class SlamMap:
    """Host wrapper: device MapState + host allocation counters + the tiny
    irregular graphs (spanning tree, loop edges) + the host mirrors."""

    state: MapState
    cfg: MapConfig
    n_kf: int = 0
    n_mp: int = 0
    parent: Optional[np.ndarray] = None       # [K] spanning-tree parent
    loop_edges: Optional[list] = None          # list of (kf_a, kf_b)
    kf_frame_id: Optional[np.ndarray] = None   # [K] source frame index
    kf_timestamp: Optional[np.ndarray] = None  # [K] float64
    # composed old->new id LUTs of the latest compactions (-1 = dropped)
    last_compaction_lut: Optional[np.ndarray] = None
    last_kf_compaction_lut: Optional[np.ndarray] = None
    kf_compactions: int = 0
    pt_compactions: int = 0
    obs_np: Optional[np.ndarray] = None
    kf_valid_np: Optional[np.ndarray] = None
    mp_valid_np: Optional[np.ndarray] = None
    host: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return self.state.kf_R.device

    @staticmethod
    def create(cfg: MapConfig, n_slots: int, device=None) -> "SlamMap":
        dev = resolve_device(device)
        K, P, N = cfg.max_keyframes, cfg.max_points, n_slots
        f32, i32 = torch.float32, torch.int32

        def z(shape, dtype=f32, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        state = MapState(
            kf_valid=z((K,), torch.bool, False),
            kf_R=torch.eye(3, dtype=f32, device=dev).repeat(K, 1, 1),
            kf_t=z((K, 3)), kf_xy=z((K, N, 2)), kf_level=z((K, N), i32),
            kf_angle=z((K, N)), kf_desc=z((K, N, 8), i32),
            kf_kp_valid=z((K, N), torch.bool, False),
            kf_obs=z((K, N), i32, -1),
            mp_valid=z((P,), torch.bool, False), mp_pos=z((P, 3)),
            mp_desc=z((P, 8), i32), mp_normal=z((P, 3)),
            mp_min_dist=z((P,)), mp_max_dist=z((P,), f32, float("inf")),
            mp_ref_kf=z((P,), i32, -1), mp_first_kf=z((P,), i32, -1),
            mp_found=z((P,), i32, 1), mp_visible=z((P,), i32, 1))
        return SlamMap(
            state=state, cfg=cfg,
            parent=np.full(K, -1, np.int64), loop_edges=[],
            kf_frame_id=np.full(K, -1, np.int64),
            kf_timestamp=np.zeros(K, np.float64),
            obs_np=np.full((K, N), -1, np.int32),
            kf_valid_np=np.zeros(K, bool), mp_valid_np=np.zeros(P, bool),
            host=dict(
                kf_R=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
                kf_t=np.zeros((K, 3), np.float32),
                kf_xy=np.zeros((K, N, 2), np.float32),
                kf_level=np.zeros((K, N), np.int32),
                kf_desc=np.zeros((K, N, 8), np.int32),
                kf_kp_valid=np.zeros((K, N), bool),
                mp_pos=np.zeros((P, 3), np.float32),
                mp_first_kf=np.full(P, -1, np.int32),
                mp_found=np.ones(P, np.int32),
                mp_visible=np.ones(P, np.int32)))

    @staticmethod
    def from_numpy(arrays: Mapping[str, np.ndarray], host: Mapping,
                   counters: Mapping, device=None) -> "SlamMap":
        """A SlamMap on `device` from a JAX package SlamMap's contents as
        numpy: `arrays` the MapState fields by name, `host` its host mirror
        dict, `counters` its host fields (n_kf, n_mp, parent, loop_edges,
        kf_frame_id, kf_timestamp, obs_np, kf_valid_np, mp_valid_np and,
        optionally, the compaction LUTs and counters).  Descriptors arrive
        as uint32 and are kept as int32 views of the same bits."""
        dev = resolve_device(device)
        missing = set(MapState._fields) - set(arrays)
        if missing:
            raise ValueError(f"missing map arrays: {sorted(missing)}")

        def conv(name, a):
            a = np.asarray(a)
            if name.endswith("desc"):
                return np.ascontiguousarray(a).view(np.int32)
            if a.dtype == np.bool_:
                return np.ascontiguousarray(a)
            if np.issubdtype(a.dtype, np.integer):
                return np.ascontiguousarray(a, np.int32)
            return np.ascontiguousarray(a, np.float32)

        state = MapState(**{n: torch.from_numpy(conv(n, arrays[n]).copy())
                            .to(dev) for n in MapState._fields})
        K, N = state.kf_obs.shape
        cfg = MapConfig(**{**dataclasses.asdict(counters["cfg"]),
                           "max_keyframes": K,
                           "max_points": state.mp_valid.shape[0]}) \
            if "cfg" in counters else MapConfig(
                max_keyframes=K, max_points=state.mp_valid.shape[0])
        h = {n: conv(n, host[n]).copy() for n in _HOST}
        smap = SlamMap(
            state=state, cfg=cfg, n_kf=int(counters["n_kf"]),
            n_mp=int(counters["n_mp"]),
            parent=np.asarray(counters["parent"], np.int64).copy(),
            loop_edges=[(int(a), int(b))
                        for a, b in counters.get("loop_edges") or []],
            kf_frame_id=np.asarray(counters["kf_frame_id"],
                                   np.int64).copy(),
            kf_timestamp=np.asarray(counters["kf_timestamp"],
                                    np.float64).copy(),
            obs_np=np.ascontiguousarray(counters["obs_np"], np.int32).copy(),
            kf_valid_np=np.asarray(counters["kf_valid_np"], bool).copy(),
            mp_valid_np=np.asarray(counters["mp_valid_np"], bool).copy(),
            kf_compactions=int(counters.get("kf_compactions", 0)),
            pt_compactions=int(counters.get("pt_compactions", 0)),
            host=h)
        for lut in ("last_compaction_lut", "last_kf_compaction_lut"):
            if counters.get(lut) is not None:
                setattr(smap, lut, np.asarray(counters[lut], np.int32).copy())
        return smap

    def set_kf_obs(self, obs_np: np.ndarray) -> None:
        """Adopt a full host observation table: one upload + mirror swap."""
        obs_np = np.ascontiguousarray(obs_np, np.int32)
        self.state = self.state._replace(
            kf_obs=upload(obs_np, self.device))
        self.obs_np = obs_np

    def set_mp_valid(self, mp_valid_np: np.ndarray) -> None:
        """Adopt a full host landmark-validity mask: one upload + swap."""
        mp_valid_np = np.ascontiguousarray(mp_valid_np, bool)
        self.state = self.state._replace(
            mp_valid=upload(mp_valid_np, self.device))
        self.mp_valid_np = mp_valid_np

    # ------------------------------------------------------------------
    # allocation (host decides ids; device tables updated in place)
    # ------------------------------------------------------------------

    def add_keyframe(self, R, t, xy, level, angle, desc, kp_valid, obs,
                     frame_id: int, timestamp: float,
                     parent: int = -1) -> int:
        """Insert a keyframe row; the row's host mirrors and the landmark
        counters' snapshots come back in one packed fetch."""
        if self.n_kf >= self.cfg.max_keyframes:
            self.compact_keyframes()
        if self.n_kf >= self.cfg.max_keyframes:
            self.grow_keyframes()
        k = self.n_kf
        dev = self.device
        s = self.state

        def dv(x, dtype):
            if isinstance(x, torch.Tensor):
                return x.to(device=dev, dtype=dtype)
            return upload(np.asarray(x), dev, dtype)

        R, t = dv(R, torch.float32), dv(t, torch.float32)
        xy, angle = dv(xy, torch.float32), dv(angle, torch.float32)
        level, kpv = dv(level, torch.int32), dv(kp_valid, torch.bool)
        desc, obs_d = dv(desc, torch.int32), dv(obs, torch.int32)
        s.kf_valid[k].fill_(True)
        s.kf_R[k] = R
        s.kf_t[k] = t
        s.kf_xy[k] = xy
        s.kf_level[k] = level
        s.kf_angle[k] = angle
        s.kf_desc[k] = desc
        s.kf_kp_valid[k] = kpv
        s.kf_obs[k] = obs_d
        # ONE fetch refreshes every mirror row from the values written
        N = s.kf_xy.shape[1]
        blob = torch.cat([
            R.reshape(-1).view(torch.int32), t.reshape(-1).view(torch.int32),
            xy.reshape(-1).view(torch.int32), level,
            desc.reshape(-1), kpv.to(torch.int32), s.mp_found,
            s.mp_visible]).cpu().numpy()
        self.parent[k] = parent
        self.obs_np[k] = np.asarray(obs.cpu() if isinstance(obs, torch.Tensor)
                                    else obs)
        self.kf_valid_np[k] = True
        h = self.host
        h["kf_R"][k] = blob[:9].view(np.float32).reshape(3, 3)
        h["kf_t"][k] = blob[9:12].view(np.float32)
        o = 12
        h["kf_xy"][k] = blob[o:o + 2 * N].view(np.float32).reshape(N, 2)
        o += 2 * N
        h["kf_level"][k] = blob[o:o + N]
        o += N
        h["kf_desc"][k] = blob[o:o + 8 * N].reshape(N, 8)
        o += 8 * N
        h["kf_kp_valid"][k] = blob[o:o + N] != 0
        o += N
        P = self.cfg.max_points
        h["mp_found"] = blob[o:o + P].copy()
        o += P
        h["mp_visible"] = blob[o:o + P].copy()
        self.kf_frame_id[k] = frame_id
        self.kf_timestamp[k] = timestamp
        self.n_kf += 1
        return k

    def grow_keyframes(self, new_max: Optional[int] = None) -> int:
        """Double the keyframe pool (ids stable; only padding is added).
        Returns the new capacity."""
        K = self.cfg.max_keyframes
        new_K = max(new_max or 2 * K, K + 1)
        pad = new_K - K
        st = self.state

        def grow(arr, fill=0):
            return torch.cat([arr, torch.full((pad,) + arr.shape[1:], fill,
                                              dtype=arr.dtype,
                                              device=arr.device)])

        self.state = st._replace(
            kf_valid=grow(st.kf_valid, False),
            kf_R=torch.cat([st.kf_R, torch.eye(
                3, dtype=st.kf_R.dtype, device=st.kf_R.device).repeat(
                    pad, 1, 1)]),
            kf_t=grow(st.kf_t), kf_xy=grow(st.kf_xy),
            kf_level=grow(st.kf_level), kf_angle=grow(st.kf_angle),
            kf_desc=grow(st.kf_desc), kf_kp_valid=grow(st.kf_kp_valid, False),
            kf_obs=grow(st.kf_obs, -1))
        self.parent = np.concatenate([self.parent, np.full(pad, -1,
                                                           np.int64)])
        self.kf_frame_id = np.concatenate(
            [self.kf_frame_id, np.full(pad, -1, np.int64)])
        self.kf_timestamp = np.concatenate([self.kf_timestamp,
                                            np.zeros(pad)])
        self.obs_np = np.concatenate(
            [self.obs_np, np.full((pad,) + self.obs_np.shape[1:], -1,
                                  np.int32)])
        self.kf_valid_np = np.concatenate([self.kf_valid_np,
                                           np.zeros(pad, bool)])
        h = self.host
        h["kf_R"] = np.concatenate(
            [h["kf_R"], np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])
        for name, fill in (("kf_t", 0), ("kf_xy", 0), ("kf_level", 0),
                           ("kf_desc", 0), ("kf_kp_valid", False)):
            arr = h[name]
            h[name] = np.concatenate(
                [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])
        if self.last_kf_compaction_lut is not None:
            lut = self.last_kf_compaction_lut
            self.last_kf_compaction_lut = np.concatenate(
                [lut[:-1], np.full(pad + 1, -1, lut.dtype)])
        self.cfg = dataclasses.replace(self.cfg, max_keyframes=new_K)
        return new_K

    def compact_points(self) -> int:
        """Pack live landmarks to the front of the pool, remap observations
        and free the culled rows.  Returns the number freed."""
        from .. import native

        st = self.state
        valid = self.mp_valid_np
        live = np.where(valid[: self.n_mp])[0]
        n_live = len(live)
        freed = self.n_mp - n_live
        if freed == 0:
            return 0
        self.pt_compactions += 1
        P = self.cfg.max_points
        lut = np.full(P + 1, -1, np.int32)
        lut[live] = np.arange(n_live, dtype=np.int32)
        if self.last_compaction_lut is None:
            self.last_compaction_lut = lut.copy()
        else:   # compose: oldest ids -> newest ids
            prev = self.last_compaction_lut
            self.last_compaction_lut = np.where(prev >= 0, lut[prev], -1)

        obs_np = self.obs_np.copy()
        native.remap_observations(obs_np, lut)
        self.obs_np = obs_np
        self.mp_valid_np = np.concatenate([np.ones(n_live, bool),
                                           np.zeros(P - n_live, bool)])
        h = self.host
        h["mp_pos"] = np.concatenate([h["mp_pos"][live],
                                      np.zeros((P - n_live, 3), np.float32)])
        h["mp_first_kf"] = np.concatenate(
            [h["mp_first_kf"][live], np.full(P - n_live, -1, np.int32)])
        for name in ("mp_found", "mp_visible"):
            h[name] = np.concatenate([h[name][live],
                                      np.ones(P - n_live, np.int32)])

        sel = _ids(live, self.device)

        def pack(arr, fill=0):
            out = torch.full_like(arr, fill)
            out[:n_live] = arr[sel]
            return out

        self.state = st._replace(
            kf_obs=upload(obs_np, self.device),
            mp_valid=upload(self.mp_valid_np, self.device),
            mp_pos=pack(st.mp_pos), mp_desc=pack(st.mp_desc),
            mp_normal=pack(st.mp_normal), mp_min_dist=pack(st.mp_min_dist),
            mp_max_dist=pack(st.mp_max_dist, float("inf")),
            mp_ref_kf=pack(st.mp_ref_kf, -1),
            mp_first_kf=pack(st.mp_first_kf, -1),
            mp_found=pack(st.mp_found, 1), mp_visible=pack(st.mp_visible, 1))
        self.n_mp = n_live
        return freed

    def compact_keyframes(self) -> int:
        """Pack live keyframes to the front of the pool and remap every
        keyframe index (spanning tree, loop edges, host metadata, the
        landmarks' reference keyframes).  The composed old->new LUT is left
        in last_kf_compaction_lut.  Returns the number of freed slots."""
        st = self.state
        K = self.cfg.max_keyframes
        live = np.where(self.kf_valid_np[: self.n_kf])[0]
        n_live = len(live)
        freed = self.n_kf - n_live
        if freed == 0:
            return 0
        self.kf_compactions += 1
        lut = np.full(K + 1, -1, np.int32)
        lut[live] = np.arange(n_live, dtype=np.int32)
        if self.last_kf_compaction_lut is None:
            self.last_kf_compaction_lut = lut.copy()
        else:
            prev = self.last_kf_compaction_lut
            self.last_kf_compaction_lut = np.where(prev >= 0, lut[prev], -1)

        dev = self.device
        sel = _ids(live, dev)

        def pack(arr, fill=0):
            out = torch.full_like(arr, fill)
            out[:n_live] = arr[sel]
            return out

        kf_R = torch.eye(3, dtype=st.kf_R.dtype, device=dev).repeat(K, 1, 1)
        kf_R[:n_live] = st.kf_R[sel]
        ref_lut = upload(lut, dev).long()

        def remap(ids):
            return torch.where(ids >= 0, ref_lut[torch.clamp(ids.long(), 0,
                                                             K)],
                               torch.full_like(ids, -1).long()).to(ids.dtype)

        self.state = st._replace(
            kf_valid=torch.arange(K, device=dev) < n_live,
            kf_R=kf_R, kf_t=pack(st.kf_t), kf_xy=pack(st.kf_xy),
            kf_level=pack(st.kf_level), kf_angle=pack(st.kf_angle),
            kf_desc=pack(st.kf_desc), kf_kp_valid=pack(st.kf_kp_valid, False),
            kf_obs=pack(st.kf_obs, -1),
            mp_ref_kf=remap(st.mp_ref_kf), mp_first_kf=remap(st.mp_first_kf))

        old_parent = self.parent.copy()
        new_parent = np.full(K, -1, np.int64)
        for old_k in live:
            p = old_parent[old_k]
            while p >= 0 and lut[p] < 0:     # walk up through culled
                p = old_parent[p]
            new_parent[lut[old_k]] = lut[p] if p >= 0 else -1
        self.parent = new_parent
        self.kf_frame_id = np.concatenate(
            [self.kf_frame_id[live], np.full(K - n_live, -1, np.int64)])
        self.kf_timestamp = np.concatenate(
            [self.kf_timestamp[live], np.zeros(K - n_live)])
        self.obs_np = np.concatenate(
            [self.obs_np[live],
             np.full((K - n_live,) + self.obs_np.shape[1:], -1, np.int32)])
        self.kf_valid_np = np.concatenate([np.ones(n_live, bool),
                                           np.zeros(K - n_live, bool)])
        h = self.host
        h["kf_R"] = np.concatenate(
            [h["kf_R"][live],
             np.tile(np.eye(3, dtype=np.float32), (K - n_live, 1, 1))])
        for name, fill in (("kf_t", 0), ("kf_xy", 0), ("kf_level", 0),
                           ("kf_desc", 0), ("kf_kp_valid", False)):
            arr = h[name]
            h[name] = np.concatenate(
                [arr[live],
                 np.full((K - n_live,) + arr.shape[1:], fill, arr.dtype)])
        first = h["mp_first_kf"]
        h["mp_first_kf"] = np.where(
            first >= 0, lut[np.clip(first, 0, K)], -1).astype(np.int32)
        self.loop_edges = [
            (int(lut[a]), int(lut[b])) for a, b in (self.loop_edges or [])
            if lut[a] >= 0 and lut[b] >= 0]
        self.n_kf = n_live
        return freed

    def alloc_point_ids(self, valid_mask) -> tuple:
        """Host-side id allocation for a batch of new points: compaction
        when the pool would overflow, then capping and sequential ids.
        Returns (ids [M] int32, -1 where unallocated; m [M] bool)."""
        m = np.asarray(valid_mask).copy()
        n_new = int(m.sum())
        if self.n_mp + n_new > self.cfg.max_points:
            self.compact_points()
        if self.n_mp + n_new > self.cfg.max_points:
            space = self.cfg.max_points - self.n_mp
            m &= np.cumsum(m) <= space
            n_new = int(m.sum())
        ids = np.full(m.shape[0], -1, np.int32)
        ids[m] = self.n_mp + np.arange(n_new, dtype=np.int32)
        return ids, m

    def _write_points(self, ids, m, pos, desc, normal, min_dist, max_dist,
                      ref_kf: int):
        """Set rows ids[m] of every landmark table (unique ids)."""
        dev = self.device
        rows = _ids(np.where(m)[0], dev)
        tgt = _ids(ids[m], dev)
        s = self.state

        def take(x, dtype):
            x = x if isinstance(x, torch.Tensor) else upload(np.asarray(x),
                                                             dev)
            return x.to(device=dev, dtype=dtype)[rows]

        n = len(ids[m])
        s.mp_valid.index_fill_(0, tgt, True)
        s.mp_pos[tgt] = take(pos, torch.float32)
        s.mp_desc[tgt] = take(desc, torch.int32)
        s.mp_normal[tgt] = take(normal, torch.float32)
        s.mp_min_dist[tgt] = take(min_dist, torch.float32)
        s.mp_max_dist[tgt] = take(max_dist, torch.float32)
        s.mp_ref_kf[tgt] = torch.full((n,), ref_kf, dtype=torch.int32,
                                      device=dev)
        s.mp_first_kf[tgt] = torch.full((n,), ref_kf, dtype=torch.int32,
                                        device=dev)
        s.mp_found.index_fill_(0, tgt, 1)
        s.mp_visible.index_fill_(0, tgt, 1)

    def add_points(self, pos, desc, normal, min_dist, max_dist, ref_kf: int,
                   valid_mask, pos_np: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        """Allocate a block of map points (masked rows are skipped).
        Returns [M] int32 ids (-1 where invalid)."""
        ids, m = self.alloc_point_ids(valid_mask)
        self._write_points(ids, m, pos, desc, normal, min_dist, max_dist,
                           ref_kf)
        if pos_np is None:
            pos_np = pos.cpu().numpy() if isinstance(pos, torch.Tensor) \
                else np.asarray(pos)
        self.note_points_added(ids, m, ref_kf, pos_np)
        return ids

    def note_points_added(self, ids, m, kf: int, pos_np: np.ndarray):
        """Host-mirror bookkeeping for points just written to the tables."""
        self.mp_valid_np[ids[m]] = True
        self.host["mp_pos"][ids[m]] = np.asarray(pos_np, np.float32)[m]
        self.host["mp_first_kf"][ids[m]] = kf
        self.n_mp += int(m.sum())

    def add_points_from_kf(self, pos, kf: int, valid_mask,
                           pos_np: Optional[np.ndarray] = None
                           ) -> np.ndarray:
        """add_points for triangulation: descriptors from keyframe kf's slot
        rows, normals/bands zeroed for the next point_stats refresh."""
        s = self.state
        M = len(np.asarray(valid_mask))
        dev = self.device
        return self.add_points(
            pos, s.kf_desc[kf][:M], torch.zeros((M, 3), device=dev),
            torch.zeros(M, device=dev),
            torch.full((M,), float("inf"), device=dev), kf, valid_mask,
            pos_np=pos_np)

    def set_observations(self, kf_id: int, slot_idx, point_ids):
        """Associate keypoint slots of keyframe kf_id with map points."""
        slot_idx = np.asarray(slot_idx, np.int64)
        point_ids = np.asarray(point_ids, np.int32)
        self.state.kf_obs[kf_id, _ids(slot_idx, self.device)] = upload(
            point_ids, self.device)
        self.obs_np[kf_id, slot_idx] = point_ids

    def set_observations_multi(self, kf_ids, slot_idx, point_ids):
        """Associate (keyframe, slot) -> point for a flat batch of
        triples (distinct (keyframe, slot) pairs)."""
        kf_ids = np.asarray(kf_ids, np.int64)
        slot_idx = np.asarray(slot_idx, np.int64)
        point_ids = np.asarray(point_ids, np.int32)
        if len(kf_ids) == 0:
            return
        dev = self.device
        self.state.kf_obs[_ids(kf_ids, dev), _ids(slot_idx, dev)] = upload(
            point_ids, dev)
        self.obs_np[kf_ids, slot_idx] = point_ids

    def set_pose(self, kf_id: int, R, t):
        dev = self.device
        Rt = R if isinstance(R, torch.Tensor) else upload(
            np.asarray(R, np.float32), dev)
        tt = t if isinstance(t, torch.Tensor) else upload(
            np.asarray(t, np.float32), dev)
        self.state.kf_R[kf_id] = Rt.to(dev, torch.float32)
        self.state.kf_t[kf_id] = tt.to(dev, torch.float32)
        self.host["kf_R"][kf_id] = np.asarray(
            R.cpu() if isinstance(R, torch.Tensor) else R, np.float32)
        self.host["kf_t"][kf_id] = np.asarray(
            t.cpu() if isinstance(t, torch.Tensor) else t, np.float32)


# ---------------------------------------------------------------------------
# derived structure (pure functions of MapState)
# ---------------------------------------------------------------------------

def covisibility_row(state: MapState, kf_id: int,
                     n_points: int) -> torch.Tensor:
    """Shared-observation counts of kf_id vs every keyframe: [K] int32
    (KeyFrame::UpdateConnections counting, src/KeyFrame.cc:332-421)."""
    obs = state.kf_obs[kf_id].long()
    seen = torch.zeros(n_points + 1, dtype=torch.bool, device=obs.device)
    seen.index_fill_(0, torch.where(obs >= 0, obs, n_points), True)
    seen[n_points].fill_(False)
    all_obs = state.kf_obs.long()
    hits = seen[torch.where(all_obs >= 0, all_obs, n_points)] & (all_obs >= 0)
    counts = hits.sum(dim=1).to(torch.int32) * state.kf_valid
    counts[kf_id] = 0
    return counts.to(torch.int32)


def covisibility_matrix(state: MapState, n_points: int) -> torch.Tensor:
    """Full [K, K] covisibility weights via the incidence product (int32).
    A keyframe observes a landmark at most once, so the incidence is 0/1."""
    K, N = state.kf_obs.shape
    obs = state.kf_obs.long()
    B = torch.zeros((K, n_points + 1), dtype=torch.float32, device=obs.device)
    B[torch.arange(K, device=obs.device)[:, None].expand(K, N),
      torch.where(obs >= 0, obs, n_points)] = 1.0
    B = B[:, :n_points]
    W = (B @ B.T).round().to(torch.int32)
    W = W * state.kf_valid[:, None] * state.kf_valid[None, :]
    return W - torch.diag(torch.diag(W))


def connected_weights(weights, min_weight: int):
    """KeyFrame::UpdateConnections edge rule (src/KeyFrame.cc:378-421): an
    edge needs weight >= min_weight; a keyframe none of whose edges pass
    keeps its single best edge.  Host-side numpy; a [K] row or [K, K]."""
    W = np.asarray(weights)
    one = W.ndim == 1
    Wm = W[None, :] if one else W
    keep = Wm >= min_weight
    none = ~keep.any(axis=1) & (Wm.max(axis=1, initial=0) > 0)
    if none.any():
        rows = np.where(none)[0]
        keep[rows, Wm[rows].argmax(axis=1)] = True
    out = np.where(keep, Wm, 0)
    return out[0] if one else out


def point_observation_counts(state: MapState) -> torch.Tensor:
    """[P] number of keyframes observing each point."""
    P = state.mp_valid.shape[0]
    obs = state.kf_obs.long()
    flat = torch.where(obs >= 0, obs, P).reshape(-1)
    counts = torch.zeros(P + 1, dtype=torch.int32,
                         device=obs.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts[:P] * state.mp_valid


def point_observation_counts_by_level(state: MapState,
                                      n_levels: int) -> torch.Tensor:
    """[P, L] cumulative observation counts: entry (p, l) is the number of
    keyframe observations of point p at octave <= l (the same-or-finer
    redundancy test of keyframe culling, src/LocalMapping.cc:563-580)."""
    P = state.mp_valid.shape[0]
    obs = state.kf_obs.long()
    pid = torch.where(obs >= 0, obs, P)
    lvl = torch.clamp(state.kf_level.long(), 0, n_levels - 1)
    flat = (pid * n_levels + lvl).reshape(-1)
    counts = torch.zeros((P + 1) * n_levels, dtype=torch.int32,
                         device=obs.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    by_level = counts[:P * n_levels].reshape(P, n_levels)
    return torch.cumsum(by_level, dim=1).to(torch.int32) \
        * state.mp_valid[:, None]
