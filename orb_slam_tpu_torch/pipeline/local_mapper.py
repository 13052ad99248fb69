"""Keyframe-rate map building, synchronous (port of
``orb_slam_tpu.pipeline.local_mapper``; the LocalMapping stage of
src/LocalMapping.cc as host orchestration of batched tensor work).

Per new keyframe (process_keyframe, the reference order of
LocalMapping::Run): cull recent points -> triangulate new points against
the covisible neighbours -> refresh point statistics -> fuse with the
neighbours -> statistics + medoid descriptors -> local BA -> keyframe
culling.  Graph logic reads the map's host mirrors; problems are sized
exactly (the JAX package's pow2 buckets and their prewarm were compile
workarounds).  The async valves (interrupt_ba / kf_queued) come with the
async mapper.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..config import SystemConfig
from ..device import upload
from ..geometry import camera as cam_mod
from ..mapping import mapstore
from ..solvers import bundle_adjust as ba
from ..utils.timing import GLOBAL_TIMER as _timer
from .. import native
from . import mapping_kernels as mk


@lru_cache(maxsize=16)
def _const(values: tuple, device) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float32), device=device)


@dataclass
class LocalMapper:
    cfg: SystemConfig
    cam: cam_mod.CameraParams
    last_culled_kfs: list = None
    _stats_fresh: bool = False

    def _sigma2(self, dev):
        return _const(tuple(np.asarray(self.cfg.extractor.sigma2,
                                       np.float32).tolist()), dev)

    def _K(self, dev):
        return _const(tuple(map(tuple, np.asarray(self.cfg.camera.K,
                                                  np.float32).tolist())),
                      dev)

    def _covis_row_np(self, smap, kf: int) -> np.ndarray:
        """Covisibility edge weights of kf vs every keyframe, on the host
        observation mirror (weight >= 15 or the best-edge fallback,
        src/KeyFrame.cc:378-421)."""
        obs = smap.obs_np
        P = self.cfg.map.max_points
        seen = np.zeros(P + 1, bool)
        own = obs[kf]
        seen[own[own >= 0]] = True
        row = (seen[np.clip(obs, 0, P)] & (obs >= 0)).sum(axis=1)
        row = row * smap.kf_valid_np
        row[kf] = 0
        return mapstore.connected_weights(
            row.astype(np.int64), self.cfg.loop.covisibility_weight_min)

    # ------------------------------------------------------------------
    def process_keyframe(self, smap: mapstore.SlamMap, kf: int) -> dict:
        """Reference stage order (LocalMapping::Run,
        src/LocalMapping.cc:46-119)."""
        metrics = {}
        with _timer.stage("mapping", "cullPoints"):
            metrics["culled_points"] = self.cull_points(smap, kf)
        self._stats_fresh = False
        with _timer.stage("mapping", "triangulate"):
            metrics["new_points"] = self.triangulate_new_points(smap, kf)
        if not self._stats_fresh:
            with _timer.stage("mapping", "pointStats"):
                self.refresh_point_stats(smap)
        with _timer.stage("mapping", "fuse"):
            metrics["fused"] = self.fuse_neighbors(smap, kf)
        with _timer.stage("mapping", "pointStats"):
            st = smap.state
            normal, min_d, max_d, new_desc = mk.point_stats_and_medoid(
                st.kf_obs, st.kf_R, st.kf_t, st.kf_level, st.kf_valid,
                st.mp_pos, st.mp_valid, st.mp_ref_kf, st.kf_desc,
                st.mp_desc, kf, n_levels=self.cfg.extractor.n_levels,
                scale_factor=self.cfg.extractor.scale_factor)
            smap.state = st._replace(mp_normal=normal, mp_min_dist=min_d,
                                     mp_max_dist=max_d, mp_desc=new_desc)
        with _timer.stage("mapping", "localBA"):
            self.local_ba(smap, kf)
        with _timer.stage("mapping", "cullKeyframes"):
            metrics["culled_kfs"] = self.cull_keyframes(smap, kf)
        return metrics

    # ------------------------------------------------------------------
    def update_descriptors(self, smap: mapstore.SlamMap, kf: int,
                           max_obs: int = 8):
        """Medoid descriptors of the landmarks kf observes
        (MapPoint::ComputeDistinctiveDescriptors)."""
        st = smap.state
        smap.state = st._replace(mp_desc=mk.refresh_medoid_descriptors(
            st.kf_obs, st.kf_desc, st.mp_desc, kf, max_obs=max_obs))

    def refresh_point_stats(self, smap: mapstore.SlamMap):
        st = smap.state
        normal, min_d, max_d = mk.point_stats(
            st.kf_obs, st.kf_R, st.kf_t, st.kf_level, st.kf_valid,
            st.mp_pos, st.mp_valid, st.mp_ref_kf,
            n_levels=self.cfg.extractor.n_levels,
            scale_factor=self.cfg.extractor.scale_factor)
        smap.state = st._replace(mp_normal=normal, mp_min_dist=min_d,
                                 mp_max_dist=max_d)

    # ------------------------------------------------------------------
    def triangulate_new_points(self, smap: mapstore.SlamMap, kf: int,
                               max_neighbors: int | None = None) -> int:
        """CreateNewMapPoints (src/LocalMapping.cc:220-386)."""
        if max_neighbors is None:
            max_neighbors = self.cfg.local_mapping.triangulation_neighbor_kfs
        weights = self._covis_row_np(smap, kf)
        order = np.argsort(-weights)
        neighbors = [int(k) for k in order[:max_neighbors] if weights[k] > 0]
        if not neighbors:
            p = int(smap.parent[kf])    # bootstrap: the initial pair
            if p >= 0:
                neighbors = [p]

        # baseline gate on host mirrors (src/LocalMapping.cc:255-266)
        centers = -np.einsum("kji,kj->ki", smap.host["kf_R"],
                             smap.host["kf_t"])
        med_depth = self._median_depth(smap, kf)
        if med_depth > 0:
            base = np.linalg.norm(centers[neighbors] - centers[kf], axis=1)
            ratio = self.cfg.local_mapping.min_baseline_depth_ratio
            neighbors = [nb for nb, b in zip(neighbors, base)
                         if b / med_depth >= ratio]
        if not neighbors:
            return 0

        st = smap.state
        dev = smap.device
        res = mk.triangulate_multi(
            kf, upload(np.asarray(neighbors, np.int64), dev),
            st.kf_xy, st.kf_desc, st.kf_level, st.kf_angle,
            st.kf_kp_valid, st.kf_obs, st.kf_R, st.kf_t,
            self._sigma2(dev), self._K(dev), self.cam,
            max_dist=self.cfg.matcher.th_low,
            epipolar_chi2=self.cfg.local_mapping.epipolar_chi2,
            reproj_chi2=self.cfg.local_mapping.reproj_chi2,
            scale_factor=self.cfg.extractor.scale_factor,
            histo_length=self.cfg.matcher.histo_length,
            check_orientation=self.cfg.matcher.check_orientation)
        blob = res.blob.cpu().numpy()                 # one fetch
        ok = blob[:, 0] > 0
        if not ok.any():
            return 0
        n_new = _commit_triangulation(
            smap, res.X, kf, blob, n_levels=self.cfg.extractor.n_levels,
            scale_factor=self.cfg.extractor.scale_factor)
        self._stats_fresh = True
        return n_new

    def fuse_neighbors(self, smap: mapstore.SlamMap, kf: int,
                       max_neighbors: int | None = None) -> int:
        """SearchInNeighbors (src/LocalMapping.cc:388-465): project the
        neighbours' landmarks into the new keyframe and its landmarks into
        the neighbours; add missing observations, merge duplicates."""
        lcfg = self.cfg.local_mapping
        if max_neighbors is None:
            max_neighbors = lcfg.fuse_neighbor_kfs
        weights = self._covis_row_np(smap, kf)
        order = np.argsort(-weights)
        neighbors = [int(k) for k in order[:max_neighbors] if weights[k] > 0]
        # extend with second neighbours (src/LocalMapping.cc:402-409)
        seen = set(neighbors) | {kf}
        for nb in list(neighbors):
            w2 = self._covis_row_np(smap, nb)
            for k2 in np.argsort(-w2)[: lcfg.fuse_second_neighbor_kfs]:
                k2 = int(k2)
                if w2[k2] > 0 and k2 not in seen:
                    neighbors.append(k2)
                    seen.add(k2)
        if not neighbors:
            return 0
        n_fused = 0
        # host working copies; ONE upload at the end
        ctx = dict(obs=smap.obs_np.copy(), mp_valid=smap.mp_valid_np.copy(),
                   changed=False)

        # neighbours' landmarks -> new keyframe
        obs_nb = ctx["obs"][neighbors]
        cand = np.unique(obs_nb[obs_nb >= 0])
        own = set(ctx["obs"][kf][ctx["obs"][kf] >= 0].tolist())
        cand = np.asarray([c for c in cand if c not in own], np.int64)
        n_fused += self._fuse_candidates_into(smap, kf, cand, ctx)

        # new keyframe's landmarks -> every neighbour, one batch + one
        # fetch; merges then apply per target in order
        own_kf = ctx["obs"][kf]
        own_ids = np.unique(own_kf[own_kf >= 0])
        cap = self.cfg.map.local_ba_max_points
        tgt_list, cand_lists = [], []
        for nb in neighbors:
            nb_obs = ctx["obs"][nb]
            nb_own = set(nb_obs[nb_obs >= 0].tolist())
            c = np.asarray([c for c in own_ids if c not in nb_own
                            and ctx["mp_valid"][c]], np.int64)[:cap]
            if len(c):
                tgt_list.append(nb)
                cand_lists.append(c)
        if tgt_list:
            M = max(len(c) for c in cand_lists)
            sels = np.zeros((len(tgt_list), M), np.int64)
            cvalid = np.zeros((len(tgt_list), M), bool)
            for i, c in enumerate(cand_lists):
                sels[i, :len(c)] = c
                cvalid[i, :len(c)] = True
            st = smap.state
            dev = smap.device
            blobs = mk.fuse_into_keyframe_tables_multi(
                st.kf_xy, st.kf_desc, st.kf_level, st.kf_kp_valid,
                st.kf_R, st.kf_t, upload(np.asarray(tgt_list, np.int64),
                                         dev),
                st.mp_pos, st.mp_desc, upload(sels, dev),
                upload(cvalid, dev), self._sigma2(dev), self.cam,
                3.0, self.cfg.matcher.th_low).cpu().numpy()
            for ti, tgt in enumerate(tgt_list):
                n_fused += self._fuse_apply(tgt, cand_lists[ti], blobs[ti],
                                            ctx)

        if ctx["changed"]:
            smap.set_kf_obs(ctx["obs"])
            smap.set_mp_valid(ctx["mp_valid"])
        return n_fused

    def _fuse_candidates_into(self, smap: mapstore.SlamMap, target_kf: int,
                              cand_ids: np.ndarray, ctx: dict) -> int:
        """Project candidate landmarks into target_kf (ORBmatcher::Fuse +
        MapPoint::Replace): one batch + one fetch, merges on ctx."""
        if len(cand_ids):
            cand_ids = cand_ids[ctx["mp_valid"][cand_ids]]
        if len(cand_ids) == 0:
            return 0
        cand_ids = cand_ids[: self.cfg.map.local_ba_max_points]
        st = smap.state
        dev = smap.device
        blob = mk.fuse_into_keyframe_tables(
            st.kf_xy, st.kf_desc, st.kf_level, st.kf_kp_valid, st.kf_R,
            st.kf_t, target_kf, st.mp_pos, st.mp_desc,
            upload(cand_ids, dev),
            torch.ones(len(cand_ids), dtype=torch.bool, device=dev),
            self._sigma2(dev), self.cam, 3.0,
            self.cfg.matcher.th_low).cpu().numpy()
        return self._fuse_apply(target_kf, cand_ids, blob, ctx)

    def _fuse_apply(self, target_kf: int, cand_ids: np.ndarray,
                    blob: np.ndarray, ctx: dict) -> int:
        """Apply one fetched (slot, ok) blob to the ctx working copies
        (observation writes, MapPoint::Replace merges)."""
        slot, ok = blob[:, 0], blob[:, 1] > 0
        obs = ctx["obs"]
        P = self.cfg.map.max_points
        obs_counts = np.bincount(obs[obs >= 0], minlength=P)
        obs_t = obs[target_kf]
        fused = 0
        replace_map = {}
        for ci in np.where(ok)[0]:
            pid = int(cand_ids[ci]) if ci < len(cand_ids) else -1
            if pid < 0 or not ctx["mp_valid"][pid]:
                continue
            s_ = int(slot[ci])
            cur = int(obs_t[s_])
            if cur == pid:
                continue
            if cur < 0:
                obs_t[s_] = pid
                fused += 1
            else:
                # duplicates: keep the better-observed one
                # (MapPoint::Replace, src/MapPoint.cc:124-158)
                keep, drop = (cur, pid) if obs_counts[cur] >= \
                    obs_counts[pid] else (pid, cur)
                replace_map[drop] = keep
                fused += 1
        if replace_map:
            drops = np.fromiter(replace_map.keys(), np.int64)
            keeps = np.fromiter((replace_map[d] for d in drops), np.int64)
            lut = np.arange(P + 1, dtype=np.int32)
            lut[drops] = keeps.astype(np.int32)
            native.remap_observations(obs, lut)
            ctx["mp_valid"][drops] = False
        if fused:
            ctx["changed"] = True
        return fused

    def _median_depth(self, smap, kf) -> float:
        """ComputeSceneMedianDepth (src/KeyFrame.cc:659-689), on host
        mirrors."""
        obs = smap.obs_np[kf]
        pid = obs[obs >= 0]
        if len(pid) == 0:
            return -1.0
        X = smap.host["mp_pos"][pid]
        z = (X @ smap.host["kf_R"][kf].T + smap.host["kf_t"][kf])[:, 2]
        return float(np.median(z)) if len(z) else -1.0

    # ------------------------------------------------------------------
    def _build_ba_problem(self, smap: mapstore.SlamMap, window, fixed_kfs,
                          point_ids):
        """A (window, fixed, points) selection as BA tensors, sized
        exactly.  Returns (Rs, ts, Xs, fixed_mask, edges, bookkeeping)."""
        mc = self.cfg.map
        if self.cfg.solver.ba_layout != "flat":
            raise NotImplementedError(
                f"ba_layout={self.cfg.solver.ba_layout!r}: only the flat "
                "layout is ported in this slice")
        window = list(window)[: mc.local_ba_max_kfs]
        fixed_kfs = list(fixed_kfs)[: mc.local_ba_max_fixed]
        cams = window + fixed_kfs
        point_ids = np.asarray(point_ids, np.int64)[: mc.local_ba_max_points]
        n_pt = len(point_ids)
        dev = smap.device

        lut = np.full(mc.max_points + 1, -1, np.int32)
        lut[point_ids] = np.arange(n_pt, dtype=np.int32)
        obs = smap.obs_np[cams]
        kpv = smap.host["kf_kp_valid"][cams]
        cam_idx, pt_idx, slot_idx, ev = native.pack_ba_edges(
            np.ascontiguousarray(obs), np.ascontiguousarray(kpv), lut)
        # only the live edges: the problem is sized exactly
        live = np.flatnonzero(ev)
        s2 = self.cfg.extractor.sigma2
        uv = smap.host["kf_xy"][cams].reshape(-1, 2)[live]
        lev = smap.host["kf_level"][cams].reshape(-1)[live]
        inv_s2 = (1.0 / s2[np.clip(lev, 0, len(s2) - 1)]).astype(np.float32)
        edges = ba.BAEdges(
            cam_idx=upload(cam_idx[live].astype(np.int64), dev),
            pt_idx=upload(pt_idx[live].astype(np.int64), dev),
            uv=upload(uv.astype(np.float32), dev),
            inv_sigma2=upload(inv_s2, dev),
            valid=torch.ones(len(live), dtype=torch.bool, device=dev))
        Rs = upload(smap.host["kf_R"][cams], dev)
        ts = upload(smap.host["kf_t"][cams], dev)
        fixed_mask = np.zeros(len(cams), bool)
        fixed_mask[len(window):] = True
        Xs = upload(smap.host["mp_pos"][point_ids].reshape(-1, 3), dev)
        book = dict(window=window, fixed=fixed_kfs, point_ids=point_ids,
                    cams=cams, slot_idx=slot_idx[live],
                    cam_idx=cam_idx[live])
        return Rs, ts, Xs, upload(fixed_mask, dev), edges, book

    def _write_back(self, smap: mapstore.SlamMap, res: ba.BAResult, book):
        """Adopt the optimized window poses/points and erase outlier
        observations (Optimizer.cc:496-521); one packed fetch patches the
        host mirrors with the values written."""
        st = smap.state
        window, point_ids = book["window"], book["point_ids"]
        n_w, n_pt = len(window), len(point_ids)
        K_p = int(res.R.shape[0])
        N = st.kf_obs.shape[1]

        hb = res.host_blob.cpu().numpy()
        o = 9 * K_p
        R_h = hb[:o].reshape(K_p, 3, 3)
        t_h = hb[o:o + 3 * K_p].reshape(K_p, 3)
        o += 3 * K_p
        X_h = hb[o:o + 3 * n_pt].reshape(n_pt, 3)
        o += 3 * n_pt
        inl = hb[o:] != 0
        bad = ~inl
        glob_cam = np.asarray(book["cams"], np.int64)[book["cam_idx"]]
        erase = (glob_cam * N + book["slot_idx"].astype(np.int64))[bad]

        _ba_write_back(st, window, res.R, res.t, point_ids, res.points,
                       erase)
        if len(erase):
            smap.obs_np.reshape(-1)[erase] = -1
        smap.host["kf_R"][window] = R_h[:n_w]
        smap.host["kf_t"][window] = t_h[:n_w]
        if n_pt:
            smap.host["mp_pos"][point_ids] = X_h

    def local_ba(self, smap: mapstore.SlamMap, center_kf: int):
        """Covisible window + its points + fixed boundary observers
        (Optimizer::LocalBundleAdjustment)."""
        mc = self.cfg.map
        weights = self._covis_row_np(smap, center_kf)
        covis = np.argsort(-weights)
        window = [center_kf] + [int(k) for k in covis[: mc.local_ba_max_kfs
                                                       - 1]
                                if weights[k] > 0]
        # gauge: keyframe 0 is always fixed (src/Optimizer.cc:357)
        if 0 in window:
            window.remove(0)
        all_obs = smap.obs_np
        obs_w = all_obs[window]
        point_ids = np.unique(obs_w[obs_w >= 0])
        point_ids = point_ids[smap.mp_valid_np[point_ids]]

        lut = np.zeros(mc.max_points + 1, bool)
        lut[point_ids] = True
        observes_local = lut[np.clip(all_obs, 0, mc.max_points)] \
            & (all_obs >= 0)
        kf_hits = observes_local.any(axis=1)
        fixed_kfs = [int(k) for k in np.where(kf_hits)[0]
                     if k not in window and smap.kf_valid_np[k]]
        if not fixed_kfs:
            fixed_kfs = [0]
        if len(window) <= 1 and not point_ids.size:
            return
        Rs, ts, Xs, fixed, edges, book = self._build_ba_problem(
            smap, window, fixed_kfs, point_ids)
        res = self._run_ba(Rs, ts, Xs, fixed, edges, two_phase=True)
        self._write_back(smap, res, book)

    def global_ba(self, smap: mapstore.SlamMap):
        """All keyframes, the first fixed (GlobalBundleAdjustemnt,
        src/Optimizer.cc:38-43)."""
        window = [k for k in range(smap.n_kf) if smap.kf_valid_np[k]]
        if len(window) < 2:
            return
        all_obs = smap.obs_np[window]
        point_ids = np.unique(all_obs[all_obs >= 0])
        Rs, ts, Xs, fixed, edges, book = self._build_ba_problem(
            smap, window[1:], [window[0]], point_ids)
        res = self._run_ba(Rs, ts, Xs, fixed, edges, two_phase=False)
        self._write_back(smap, res, book)

    def _run_ba(self, Rs, ts, Xs, fixed, edges, two_phase: bool):
        if self.cfg.mesh.data_parallel > 1:
            raise NotImplementedError(
                "the landmark-sharded BA (mesh.data_parallel > 1) comes with "
                "the multi-device slice of the port")
        return ba.bundle_adjust(Rs, ts, Xs, fixed, edges, self.cam,
                                self.cfg.solver, two_phase=two_phase,
                                layout=self.cfg.solver.ba_layout)

    # ------------------------------------------------------------------
    def cull_keyframes(self, smap: mapstore.SlamMap, current_kf: int) -> int:
        """KeyFrameCulling (src/LocalMapping.cc:539-593): drop a covisible
        keyframe when >= 90% of its landmarks are seen by >= 3 other
        keyframes at the same or finer octave.  Never keyframe 0, the
        current one, or one holding a loop edge."""
        lm_cfg = self.cfg.local_mapping
        n_levels = self.cfg.extractor.n_levels
        P = self.cfg.map.max_points
        weights = self._covis_row_np(smap, current_kf)
        candidates = [int(k) for k in np.where(weights > 0)[0]]
        protected = {0, current_kf}
        for a, b in (smap.loop_edges or []):
            protected |= {a, b}
        obs_m = smap.obs_np.copy()
        lvl_m = smap.host["kf_level"]

        def counts_by_level(obs):
            sel = obs >= 0
            flat = obs[sel] * n_levels + np.clip(lvl_m[sel], 0, n_levels - 1)
            c = np.bincount(flat, minlength=P * n_levels)
            return np.cumsum(c.reshape(P, n_levels), axis=1)

        counts_le = counts_by_level(obs_m)
        self.last_culled_kfs = []
        for k in candidates:
            if k in protected or not smap.kf_valid_np[k]:
                continue
            obs = obs_m[k]
            sel = obs >= 0
            pid = obs[sel]
            if len(pid) < 10:
                continue
            lvl = np.clip(lvl_m[k][sel] + 1, 0, n_levels - 1)
            redundant = counts_le[pid, lvl] - 1 >= lm_cfg.kf_culling_min_obs
            if redundant.mean() >= lm_cfg.kf_culling_redundancy:
                self._erase_keyframe(smap, k)
                obs_m[k] = -1
                counts_le = counts_by_level(obs_m)
                self.last_culled_kfs.append(k)
        return len(self.last_culled_kfs)

    def _erase_keyframe(self, smap: mapstore.SlamMap, k: int):
        """Remove keyframe k: clear its observations, invalidate it, and
        greedily re-parent its spanning-tree children (KeyFrame.cc:519-588)
        by the highest covisibility weight; children with no covisible
        candidate fall back to k's parent."""
        children = [c for c in range(smap.n_kf) if int(smap.parent[c]) == k]
        p = int(smap.parent[k])
        W = None
        if children:
            W = mapstore.connected_weights(
                native.covisibility_counts(
                    smap.obs_np, smap.kf_valid_np,
                    self.cfg.map.max_points).astype(np.int64),
                self.cfg.loop.covisibility_weight_min)
        _erase_kf(smap.state, k)
        smap.obs_np[k] = -1
        smap.kf_valid_np[k] = False
        smap.host["kf_kp_valid"][k] = False

        candidates = {p} if p >= 0 else set()
        pending = set(children)
        while pending and candidates:
            best_w, best_c, best_p = 0, -1, -1
            for c in sorted(pending):
                for q in sorted(candidates):
                    if W[c, q] > best_w:
                        best_w, best_c, best_p = int(W[c, q]), c, q
            if best_c < 0:
                break
            smap.parent[best_c] = best_p
            candidates.add(best_c)
            pending.discard(best_c)
        for c in pending:
            smap.parent[c] = p
        smap.parent[k] = -1

    # ------------------------------------------------------------------
    def cull_points(self, smap: mapstore.SlamMap, current_kf: int) -> int:
        """MapPointCulling (src/LocalMapping.cc:190-218): drop recent points
        with found/visible < 0.25, or too few observations after a 2-KF
        grace window."""
        lm_cfg = self.cfg.local_mapping
        P = self.cfg.map.max_points
        obs_m = smap.obs_np
        counts = np.bincount(obs_m[obs_m >= 0], minlength=P)
        found = smap.host["mp_found"]
        visible = smap.host["mp_visible"]
        first = smap.host["mp_first_kf"]
        valid = smap.mp_valid_np
        age = current_kf - first
        recent = age <= 3
        ratio_bad = (found / np.maximum(visible, 1)) \
            < lm_cfg.culling_min_found_ratio
        obs_bad = (age >= lm_cfg.culling_obs_window_kfs) & (
            counts <= lm_cfg.culling_min_obs)
        bad = valid & recent & (ratio_bad | obs_bad)
        if not bad.any():
            return 0
        obs = obs_m.copy()
        obs[bad[np.clip(obs, 0, P - 1)] & (obs >= 0)] = -1
        smap.set_kf_obs(obs)
        smap.set_mp_valid(valid & ~bad)
        return int(bad.sum())


# ---------------------------------------------------------------------------
# commits of the keyframe-rate stages to the device tables (the JAX
# package's _commit_triangulation_jit, _ba_write_back_jit, _erase_kf_jit)
# ---------------------------------------------------------------------------

def _commit_triangulation(smap: mapstore.SlamMap, X: torch.Tensor, kf: int,
                          blob: np.ndarray, *, n_levels: int,
                          scale_factor: float) -> int:
    """Insert the triangulated points (blob rows [ok, X, slot2, nb_of];
    ids allocated here, compacting the pool if it would overflow), write
    the kf and winning-neighbour observation rows, and refresh point_stats
    on the updated map.  Returns the number of points added."""
    ids = smap.add_points_from_kf(X, kf, blob[:, 0] > 0,
                                  pos_np=np.ascontiguousarray(blob[:, 1:4]))
    slots1 = np.where(ids >= 0)[0]
    smap.set_observations_multi(
        np.concatenate([np.full(len(slots1), kf, np.int32),
                        blob[slots1, 5].astype(np.int32)]),
        np.concatenate([slots1.astype(np.int32),
                        blob[slots1, 4].astype(np.int32)]),
        np.concatenate([ids[slots1], ids[slots1]]))
    st = smap.state
    normal, min_d, max_d = mk.point_stats(
        st.kf_obs, st.kf_R, st.kf_t, st.kf_level, st.kf_valid, st.mp_pos,
        st.mp_valid, st.mp_ref_kf, n_levels=n_levels,
        scale_factor=scale_factor)
    smap.state = st._replace(mp_normal=normal, mp_min_dist=min_d,
                             mp_max_dist=max_d)
    return len(slots1)


def _ba_write_back(st: mapstore.MapState, window, Rn, tn, point_ids, Xn,
                   erase: np.ndarray) -> None:
    """Scatter the window poses and point positions (rows [:len(window)]
    and [:len(point_ids)] of the solver's output) and erase the outlier
    observations (flat kf_obs indices), in place."""
    dev = st.kf_R.device
    n_w, n_pt = len(window), len(point_ids)
    if n_w:
        w_idx = upload(np.asarray(window, np.int64), dev)
        st.kf_R[w_idx] = Rn[:n_w]
        st.kf_t[w_idx] = tn[:n_w]
    if n_pt:
        st.mp_pos[upload(np.asarray(point_ids, np.int64), dev)] = Xn[:n_pt]
    if len(erase):
        st.kf_obs.view(-1).index_fill_(0, upload(erase, dev), -1)


def _erase_kf(st: mapstore.MapState, k: int) -> None:
    """Keyframe erasure on the tables (validity, observations, keypoints),
    in place."""
    st.kf_valid[k].fill_(False)
    st.kf_obs[k].fill_(-1)
    st.kf_kp_valid[k].fill_(False)
