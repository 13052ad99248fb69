"""Loop detection, the geometric check of loop candidates and the loop
correction at keyframe rate (port of ``orb_slam_tpu.pipeline.loop_closer``).

The LoopClosing thread of the reference (src/LoopClosing.cc) per new
keyframe:
  1. DetectLoop (:99-229): BoW candidates gated by a minimum score against
     the covisible neighbourhood and by covisibility consistency across 3
     consecutive keyframes;
  2. ComputeSim3 (:231-406): descriptor matching against each candidate's
     landmarks, Sim3 RANSAC and refinement, acceptance by inlier and
     total-match counts;
  3. CorrectLoop (:408-570): the corrected Sim3 propagated to the current
     covisibility group and its landmarks, loop fusion, the essential-graph
     optimization over every keyframe (the loop keyframe fixed) and the
     re-mapping of every landmark through its reference keyframe.  (ORB-SLAM
     v1 runs no global BA after a loop, and neither does this.)

The state kept across keyframes: the vocabulary, the keyframe database,
one BoW row per keyframe, the consistent groups, the last loop keyframe
and the CPU generator of the Sim3 RANSAC draws.  The tracker's
relocalisation reads the same vocabulary and database.

Detection is host numpy: the BoW transform reads the keyframe rows' host
mirrors, covisibility comes from the observation mirror through the
compiled graph ops, so it costs no device read.  The check runs on the
map's device; per checked candidate it reads the card four times at most
(the match indices, RANSAC's ``ok``, the refined inlier count, the guided
match count), and RANSAC's CUDA SVD waits for the card at its own status
checks.  The correction runs on the map's device too: its snapshot comes
from the host mirrors, its propagation and edge measurements are one
batched compose each, and the card is read by the loop fusion's fetches
and by the pose and position mirrors' refresh after each whole-map write.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .. import native
from ..config import SolverConfig, SystemConfig
from ..device import true_fp32, upload
from ..geometry import se3, sim3
from ..geometry.camera import CameraParams
from ..mapping import mapstore
from ..ops import match as match_ops
from ..parallel import dist_pose_graph, hostmesh
from ..place import database as db_mod
from ..place import vocabulary as voc_mod
from ..solvers import pnp, pose_graph, sim3_opt, sim3_solver
from ..utils.timing import GLOBAL_TIMER as _timer
from .local_mapper import LocalMapper

# the JAX loop closer's key is PRNGKey(7) (loop_closer.py:96)
SIM3_SEED = 7


def ransac_budget(scfg: SolverConfig, n_pairs: int) -> int:
    """Sim3 RANSAC hypotheses for n_pairs matched pairs: the adaptive count
    the reference seeds with SetRansacParameters(0.99, 20, 300)
    (Sim3Solver.cc:59-83), eps = min_inliers / N and iters = log(1 - p) /
    log(1 - eps^3), capped at sim3_max_iters with a floor of 32, then
    rounded up to a power of two as the JAX package does
    (loop_closer.py:284, where it bounds recompiles)."""
    eps = min(1.0 - 1e-6, scfg.sim3_min_inliers / max(n_pairs, 1))
    n = int(np.ceil(np.log(max(1e-9, 1.0 - scfg.sim3_prob))
                    / np.log(1.0 - eps ** 3)))
    n = max(32, min(n, scfg.sim3_max_iters))
    return 1 << (n - 1).bit_length()


class LoopPairs(NamedTuple):
    """The 3D-3D pairs of a keyframe against a loop candidate, one row per
    slot of the keyframe, on the map's device."""
    X1: torch.Tensor        # [N, 3] landmark in the keyframe's camera frame
    X2: torch.Tensor        # [N, 3] matched landmark in the candidate's
    uv1: torch.Tensor       # [N, 2] keypoint pixels in the keyframe
    uv2: torch.Tensor       # [N, 2] matched keypoint pixels in the candidate
    max_err1: torch.Tensor  # [N] 9.21 sigma^2 of the keypoint's octave
    max_err2: torch.Tensor  # [N]
    valid: torch.Tensor     # [N] bool
    valid_np: np.ndarray    # [N] bool, the same on the host


@dataclass
class LoopCloser:
    cfg: SystemConfig
    cam: CameraParams
    voc: Optional[voc_mod.Vocabulary] = None
    db: Optional[db_mod.BowDatabase] = None
    kf_bow: dict = field(default_factory=dict)
    last_loop_kf: int = -(10 ** 9)
    consistent_groups: List = field(default_factory=list)
    n_loops_closed: int = 0
    # Sim3 RANSAC minimal sets: drawn from this CPU generator, unless
    # sim3_sampler is set: sim3_sampler(valid [N] bool numpy, n_samples) ->
    # [n_samples, 3] indices.  One draw per candidate that reaches RANSAC,
    # where the JAX loop closer splits its key
    generator: torch.Generator = field(
        default_factory=lambda: torch.Generator().manual_seed(SIM3_SEED))
    sim3_sampler: Optional[Callable] = None

    def remap_keyframes(self, lut: np.ndarray):
        """Apply a keyframe-pool compaction LUT (old id -> new id, -1 =
        dropped) to every keyframe-indexed structure this stage owns."""
        if self.db is not None:
            ids, w, has = self.db.ids, self.db.w, self.db.has_row
            new_ids = np.full_like(ids, voc_mod.PAD_ID)
            new_w = np.zeros_like(w)
            new_has = np.zeros_like(has)
            old = np.where(has & (lut[: len(has)] >= 0))[0]
            nk = lut[old]
            new_ids[nk] = ids[old]
            new_w[nk] = w[old]
            new_has[nk] = True
            self.db = db_mod.BowDatabase(ids=new_ids, w=new_w,
                                         has_row=new_has)
        self.kf_bow = {int(lut[k]): v for k, v in self.kf_bow.items()
                       if lut[k] >= 0}
        self.consistent_groups = [
            ({int(lut[k]) for k in group if lut[k] >= 0}, count)
            for group, count in self.consistent_groups]
        self.consistent_groups = [(g, c) for g, c in self.consistent_groups
                                  if g]
        if self.last_loop_kf >= 0:
            nk = int(lut[self.last_loop_kf])
            # a dropped anchor would make min_kfs_between_loops count from
            # an unrelated keyframe
            self.last_loop_kf = nk if nk >= 0 else -(10 ** 9)

    def reset(self):
        """Forget the old map's keyframes (a full system reset); the
        vocabulary stays."""
        self.kf_bow = {}
        self.consistent_groups = []
        self.last_loop_kf = -(10 ** 9)
        if self.voc is not None:
            self.db = db_mod.BowDatabase.create(
                self.cfg.map.max_keyframes, self.cfg.extractor.max_keypoints)

    def _covis_np(self, smap: mapstore.SlamMap) -> np.ndarray:
        """[K, K] covisibility weights under the edge rule (weight >= 15
        or the best edge, KeyFrame.cc:378-421), from the observation
        mirror.  The JAX package caches this per kf_obs array; the port's
        tables are written in place, so an identity-keyed cache would go
        stale, and the sparse count is cheap (it follows the observation
        count)."""
        W = native.covisibility_counts(
            smap.obs_np, smap.kf_valid_np,
            self.cfg.map.max_points).astype(np.int64)
        return mapstore.connected_weights(
            W, self.cfg.loop.covisibility_weight_min)

    def ensure_vocabulary(self, descriptors):
        """Vocabulary priority (TemplatedVocabulary::loadFromTextFile's
        role): an explicit path (.npz or ORBvoc.txt) > the shipped 10^4-word
        vocabulary > training on `descriptors` (the init frames'; a
        fallback for tiny synthetic worlds).  `descriptors` may be a
        callable returning them, called only if training is needed."""
        if self.voc is None:
            if self.cfg.loop.vocab_path:
                p = self.cfg.loop.vocab_path
                self.voc = (voc_mod.load_npz(p) if p.endswith(".npz")
                            else voc_mod.load_orbvoc_text(p))
            elif (self.cfg.loop.vocab_use_prebuilt
                  and voc_mod.prebuilt() is not None):
                self.voc = voc_mod.prebuilt()
            else:
                if callable(descriptors):
                    descriptors = descriptors()
                self.voc = voc_mod.train(
                    descriptors, k=self.cfg.loop.vocab_branching,
                    depth=self.cfg.loop.vocab_depth)
            self.db = db_mod.BowDatabase.create(
                self.cfg.map.max_keyframes, self.cfg.extractor.max_keypoints)

    def ensure_capacity(self, max_kf: int):
        """Re-pad the database rows after keyframe-pool growth (ids
        stable, capacity doubled)."""
        if self.db is not None and len(self.db.has_row) < max_kf:
            self.db = self.db.grown(max_kf)

    def add_keyframe(self, smap: mapstore.SlamMap, kf: int):
        """The keyframe's BoW row, from its descriptor and validity
        mirrors (filled by the insertion's one packed fetch), into the
        database."""
        self.ensure_capacity(smap.cfg.max_keyframes)
        with _timer.stage("loopclosing", "bowTransform"):
            bow = voc_mod.transform_np(
                self.voc, smap.host["kf_desc"][kf],
                smap.host["kf_kp_valid"][kf])
        self.kf_bow[kf] = bow
        self.db = self.db.add(kf, bow)

    # ------------------------------------------------------------------
    def process_keyframe(self, smap: mapstore.SlamMap, kf: int) -> dict:
        """Add the keyframe to the database, run loop detection, the
        geometric check of the consistent candidates (``loop_candidates``;
        ``loop_with``: the first candidate that passes) and the correction
        of a verified loop (``loop_closed``).  A closed loop sets
        ``last_loop_kf``, so the next min_kfs_between_loops keyframes are
        not checked."""
        metrics = {}
        if self.voc is None:
            return metrics
        self.add_keyframe(smap, kf)
        if kf - self.last_loop_kf < self.cfg.loop.min_kfs_between_loops \
                or smap.n_kf < self.cfg.loop.min_kfs_between_loops:
            return metrics

        with _timer.stage("loopclosing", "detect"):
            cand = self._detect(smap, kf)
        metrics["loop_candidates"] = len(cand)
        if not len(cand):
            return metrics

        with _timer.stage("loopclosing", "computeSim3"):
            hit = self._compute_sim3(smap, kf, cand)
        if hit is None:
            return metrics
        loop_kf, g12 = hit
        metrics["loop_with"] = loop_kf
        with _timer.stage("loopclosing", "correctLoop"):
            self._correct(smap, kf, loop_kf, g12)
        self.last_loop_kf = kf
        self.n_loops_closed += 1
        metrics["loop_closed"] = True
        return metrics

    # ------------------------------------------------------------------
    def _detect(self, smap: mapstore.SlamMap, kf: int) -> np.ndarray:
        covis = self._covis_np(smap)
        neighbors = np.where(covis[kf] > 0)[0]

        # minScore = the least BoW similarity over the covisible
        # neighbourhood (LoopClosing.cc:119-136), non-empty by construction
        # in the reference.  A neighbour-free keyframe has no data-derived
        # floor: detection is skipped for it, and the groups are cleared
        # as the reference does whenever detection yields no candidate
        # (:146-150)
        bow = self.kf_bow[kf]
        scores = [voc_mod.score_l1_np(bow, self.kf_bow[int(nb)])
                  for nb in neighbors if int(nb) in self.kf_bow]
        if not scores:
            self.consistent_groups = []
            return np.zeros(0, np.int64)
        min_score = min(scores)

        exclude = np.zeros(len(self.db.has_row), bool)
        exclude[kf] = True
        exclude[neighbors] = True
        covis = covis.astype(np.float64)
        cand = db_mod.detect_candidates(
            self.db, bow, exclude, covis,
            min_score=max(min_score, 1e-3),
            shared_ratio=self.cfg.loop.shared_word_ratio,
            acc_ratio=self.cfg.loop.acc_score_ratio,
            top_group=self.cfg.loop.covisibility_group_top,
        )

        # covisibility consistency over consecutive keyframes
        # (LoopClosing.cc:152-228): a candidate must reappear, sharing a
        # covisibility group, for consistency_threshold keyframes
        enough = []
        new_groups = []
        for c in cand:
            group = set(np.where(covis[c] > 0)[0].tolist()) | {int(c)}
            matched = False
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    new_groups.append((group, count + 1))
                    if count + 1 >= self.cfg.loop.consistency_threshold:
                        enough.append(int(c))
                    matched = True
                    break
            if not matched:
                new_groups.append((group, 1))
        self.consistent_groups = new_groups
        return np.asarray(enough, np.int64)

    # ------------------------------------------------------------------
    def _compute_sim3(self, smap: mapstore.SlamMap, kf: int, cands):
        """ComputeSim3 (LoopClosing.cc:231-406) over the candidates in
        order: descriptor matching, Sim3 RANSAC, the refinement and the
        guided match count.  Returns (cand, (s, R, t)) for the first
        candidate that passes, g12 mapping the candidate's camera frame
        into the keyframe's; None when none does."""
        dev = smap.device
        lcfg, scfg = self.cfg.loop, self.cfg.solver
        K = upload(self.cfg.camera.K, dev)
        for cand in cands:
            cand = int(cand)
            pairs = self._loop_pairs(smap, kf, cand)
            if pairs is None:
                continue
            samples = self._sim3_samples(
                pairs.valid_np, ransac_budget(scfg, int(pairs.valid_np.sum())))
            res = sim3_solver.sim3_ransac(
                *pairs[:7], K, samples=upload(samples, dev),
                min_inliers=lcfg.min_sim3_inliers)
            if not bool(res.ok):
                continue
            # the refinement with bidirectional reprojection edges
            # (Optimizer::OptimizeSim3, LoopClosing.cc:328), each pair
            # weighted by 1 / sigma^2 of its octaves
            isig1 = 1.0 / torch.clamp(pairs.max_err1 / 9.21, min=1e-9)
            isig2 = 1.0 / torch.clamp(pairs.max_err2 / 9.21, min=1e-9)
            with true_fp32():
                ref = sim3_opt.optimize_sim3(
                    res.s, res.R, res.t, *pairs[:4], isig1, isig2,
                    res.inliers, K, chi2_th=scfg.sim3_chi2,
                    iters1=scfg.sim3_iters1, iters2=scfg.sim3_iters2)
            if int(ref.n_inliers) < lcfg.min_sim3_inliers:
                continue
            # guided projection matching through the refined Sim3
            # (SearchBySim3 / SearchByProjection, LoopClosing.cc:324,379):
            # the final accept counts all matches, not only the inliers
            g12 = (ref.s, ref.R, ref.t)
            if self._count_guided_matches(smap, kf, cand, g12) \
                    >= lcfg.min_total_matches:
                return cand, g12
        return None

    def _sim3_samples(self, valid: np.ndarray, n_samples: int
                      ) -> torch.Tensor:
        if self.sim3_sampler is not None:
            return torch.as_tensor(np.asarray(
                self.sim3_sampler(valid, n_samples), np.int64))
        return pnp.draw_samples(self.generator, valid, n_samples, 3)

    def _loop_pairs(self, smap: mapstore.SlamMap, kf: int,
                    cand: int) -> Optional[LoopPairs]:
        """Landmark-to-landmark descriptor matching of the keyframe's
        observed slots against the candidate's (the role of SearchByBoW;
        the dense match needs no BoW gating) at th_low with ratio 0.75, and
        the matched landmarks in each keyframe's camera frame.  None below
        min_bow_matches observed slots on either side or matches."""
        st = smap.state
        dev = smap.device
        need = self.cfg.loop.min_bow_matches
        obs1, obs2 = smap.obs_np[kf], smap.obs_np[cand]
        if (obs1 >= 0).sum() < need or (obs2 >= 0).sum() < need:
            return None
        dist = match_ops.hamming_matrix(st.kf_desc[kf], st.kf_desc[cand])
        mask = match_ops.valid_mask(upload(obs1 >= 0, dev),
                                    upload(obs2 >= 0, dev))
        mm = match_ops.match_nn(match_ops.apply_masks(dist, mask),
                                max_dist=self.cfg.matcher.th_low, ratio=0.75)
        mm = match_ops.resolve_duplicates(mm, st.kf_desc.shape[1])
        # the one read of the matching: a row's index is -1 where it has
        # no match
        idx = mm.idx.cpu().numpy()
        if (idx >= 0).sum() < need:
            return None
        idx2 = np.clip(idx, 0, None)
        pid2 = obs2[idx2]
        pv = (idx >= 0) & (obs1 >= 0) & (pid2 >= 0)
        Xw1 = st.mp_pos[upload(np.clip(obs1, 0, None).astype(np.int64), dev)]
        Xw2 = st.mp_pos[upload(np.clip(pid2, 0, None).astype(np.int64), dev)]
        sigma2 = self.cfg.extractor.sigma2
        top = len(sigma2) - 1
        lv1 = smap.host["kf_level"][kf]
        lv2 = smap.host["kf_level"][cand][idx2]
        idx2_d = upload(idx2.astype(np.int64), dev)
        return LoopPairs(
            X1=se3.transform(st.kf_R[kf], st.kf_t[kf], Xw1),
            X2=se3.transform(st.kf_R[cand], st.kf_t[cand], Xw2),
            uv1=st.kf_xy[kf], uv2=st.kf_xy[cand][idx2_d],
            max_err1=upload(9.21 * sigma2[np.clip(lv1, 0, top)], dev,
                            torch.float32),
            max_err2=upload(9.21 * sigma2[np.clip(lv2, 0, top)], dev,
                            torch.float32),
            valid=upload(pv, dev), valid_np=pv)

    def _count_guided_matches(self, smap: mapstore.SlamMap, kf: int,
                              cand: int, g12) -> int:
        """Project the landmarks of the candidate and its top-5 covisible
        keyframes through g12 into the keyframe and count the descriptor
        matches inside a 12 px window (SearchByProjection through Scw,
        ORBmatcher.cc:286)."""
        st = smap.state
        dev = smap.device
        s, R, t = g12
        w2 = self._covis_np(smap)[cand]
        group = [cand] + [int(k) for k in np.argsort(-w2)[:5] if w2[k] > 0]
        obs_g = smap.obs_np[group]
        pid = np.unique(obs_g[obs_g >= 0])
        if len(pid) == 0:
            return 0
        # the JAX package's fixed-size window: the first ids in sorted
        # order, padded with id 0 marked invalid
        cap = self.cfg.map.local_ba_max_points
        pid = pid[:cap].astype(np.int64)
        sel = upload(np.concatenate([pid, np.zeros(cap - len(pid),
                                                   np.int64)]), dev)
        pvalid = upload(np.arange(cap) < len(pid), dev) & st.mp_valid[sel]

        # landmark -> keyframe camera frame through the refined Sim3
        Xc = sim3.transform(s, R, t, se3.transform(
            st.kf_R[cand], st.kf_t[cand], st.mp_pos[sel]))
        z = Xc[:, 2]
        Kc = self.cfg.camera.K
        zc = torch.clamp(z, min=1e-6)
        uv = torch.stack([Xc[:, 0] / zc * float(Kc[0, 0]) + float(Kc[0, 2]),
                          Xc[:, 1] / zc * float(Kc[1, 1]) + float(Kc[1, 2])],
                         dim=1)
        cam = self.cam
        ok = (pvalid & (z > 0)
              & (uv[:, 0] >= cam.min_x) & (uv[:, 0] < cam.max_x)
              & (uv[:, 1] >= cam.min_y) & (uv[:, 1] < cam.max_y))

        dist = match_ops.hamming_matrix(st.mp_desc[sel], st.kf_desc[kf])
        mask = (match_ops.window_mask(uv, st.kf_xy[kf], 12.0)
                & match_ops.valid_mask(ok, st.kf_kp_valid[kf]))
        mm = match_ops.match_nn(match_ops.apply_masks(dist, mask),
                                max_dist=self.cfg.matcher.th_low)
        mm = match_ops.resolve_duplicates(mm, st.kf_desc.shape[1])
        return int(mm.valid.sum())

    # ------------------------------------------------------------------
    def _correct(self, smap: mapstore.SlamMap, kf: int, loop_kf: int, g12):
        """CorrectLoop in the reference's order (LoopClosing.cc:408-570):

        1. propagate the corrected Sim3 to the current covisibility group
           and correct the group's landmarks (:425-479, the CorrectedSim3 /
           NonCorrectedSim3 maps);
        2. fuse the loop side's landmarks into the corrected group
           (:505-527) and collect the new covisibility links the fusion
           made, the LoopConnections (:529-546);
        3. optimize the essential graph seeded with the corrected poses,
           its edges measured from the pre-correction poses (:548), then
           re-map every landmark through its (possibly propagated)
           reference pose (Optimizer.cc:746-779).

        g12 = (s, R, t) maps the loop keyframe's camera frame into kf's."""
        n_kf = smap.n_kf
        # the pre-correction snapshot (NonCorrectedSim3, s = 1 embeddings
        # of the SE3 poses), from the host mirrors
        snap = self._snapshot(smap, n_kf)
        covis = self._covis_np(smap)[:n_kf, :n_kf]
        group = [kf] + [int(g) for g in np.where(covis[kf] > 0)[0]
                        if g != kf]
        corr = self._propagate(snap, group, kf, loop_kf, g12)

        # each group-observed landmark is corrected once, by its first
        # observing group member (mnCorrectedByKF, LoopClosing.cc:443-461)
        P = smap.state.mp_valid.shape[0]
        corrected_by = np.full(P, -1, np.int32)
        for i in group:
            pid = smap.obs_np[i]
            pid = pid[pid >= 0]
            corrected_by[pid[corrected_by[pid] < 0]] = i
        self._write_propagated(smap, snap, corr, corrected_by)

        self._search_and_fuse(smap, kf, loop_kf)
        loop_pairs = self._loop_connections(smap, covis, group)
        edges = self._graph_edges(smap, covis, loop_pairs, snap, corr, kf,
                                  loop_kf, g12)
        new = self._solve_graph(corr, edges, loop_kf)
        self._remap(smap, snap, corr, new, corrected_by)
        smap.loop_edges.append((kf, loop_kf))

    def _snapshot(self, smap: mapstore.SlamMap, n_kf: int):
        """(s, R, t) of keyframes 0..n_kf-1 on the map's device, s = 1,
        from the pose mirrors (no device read)."""
        dev = smap.device
        return (torch.ones(n_kf, dtype=torch.float32, device=dev),
                upload(smap.host["kf_R"][:n_kf], dev),
                upload(smap.host["kf_t"][:n_kf], dev))

    @staticmethod
    def _propagate(snap, group, kf: int, loop_kf: int, g12):
        """The corrected Sim3 of every keyframe: g12 o S_loop for kf
        (mg2oScw = gScm * Smw), (S_i o S_kf^-1) o S_kf_corrected for the
        rest of the group (CorrectedSim3, LoopClosing.cc:425-441), the
        snapshot elsewhere.  One batched compose over the group, in
        float32."""
        s, R, t = snap
        dev = s.device
        gs, gR, gt = (x.to(device=dev, dtype=torch.float32) for x in g12)
        s_kfc, R_kfc, t_kfc = sim3.compose(gs, gR, gt, s[loop_kf],
                                           R[loop_kf], t[loop_kf])
        rest = upload(np.asarray(group[1:], np.int64), dev)
        inv = sim3.inverse(s[kf], R[kf], t[kf])
        sik, Rik, tik = sim3.compose(s[rest], R[rest], t[rest], *inv)
        si, Ri, ti = sim3.compose(sik, Rik, tik, s_kfc, R_kfc, t_kfc)
        s_c, R_c, t_c = s.clone(), R.clone(), t.clone()
        s_c[kf], R_c[kf], t_c[kf] = s_kfc, R_kfc, t_kfc
        s_c[rest], R_c[rest], t_c[rest] = si, Ri, ti
        return s_c, R_c, t_c

    @staticmethod
    def _write_pose_tables(smap: mapstore.SlamMap, s, R, t, mp_pos):
        """Write Sim3 keyframe poses as SE3 (scale folded into t: [R, t/s],
        LoopClosing.cc:470-477) and the landmark positions, then re-read
        their mirrors."""
        n_kf = s.shape[0]
        st = smap.state
        R_se3, t_se3 = sim3.to_se3(s, R, t)
        st.kf_R[:n_kf] = se3.orthonormalize(R_se3)
        st.kf_t[:n_kf] = t_se3
        st.mp_pos.copy_(mp_pos)
        smap.refresh_host("kf_R", "kf_t", "mp_pos")

    def _write_propagated(self, smap: mapstore.SlamMap, snap, corr,
                          corrected_by: np.ndarray):
        """Move the group's landmarks with their correcting member and
        write the propagated poses, so that the fusion projects with
        them."""
        st = smap.state
        touched = upload(corrected_by >= 0, smap.device)
        ref = upload(np.maximum(corrected_by, 0).astype(np.int64),
                     smap.device)
        prop = pose_graph.correct_points(st.mp_pos, ref, *snap, *corr)
        self._write_pose_tables(
            smap, *corr,
            torch.where((touched & st.mp_valid)[:, None], prop, st.mp_pos))

    def _loop_connections(self, smap: mapstore.SlamMap, covis: np.ndarray,
                          group) -> set:
        """The (group member, keyframe) links at covisibility_weight_strong
        or above that the fusion made: to keyframes outside the group that
        the member was not linked to before (LoopClosing.cc:529-546)."""
        n_kf = covis.shape[0]
        after = self._covis_np(smap)[:n_kf, :n_kf]
        strong = self.cfg.loop.covisibility_weight_strong
        in_group = set(group)
        pairs = set()
        for i in group:
            before = covis[i] > 0
            for j in np.where(after[i] >= strong)[0].tolist():
                if j != i and j not in in_group and not before[j]:
                    pairs.add((i, j))
        return pairs

    def _graph_edges(self, smap: mapstore.SlamMap, covis: np.ndarray,
                     loop_pairs: set, snap, corr, kf: int, loop_kf: int,
                     g12) -> pose_graph.Sim3Edges:
        """The essential graph's edges in the JAX package's order: the
        spanning tree, the strong covisibility and the old loop edges,
        sorted and measured from the snapshot; the LoopConnections, sorted
        and measured from the corrected poses (Optimizer.cc:604-631 reads
        vScw); the new loop edge g12.  A measurement is S_a o S_b^-1; all
        of them come from one batched compose over the stacked snapshot
        and corrected poses."""
        n_kf = covis.shape[0]
        pairs = set()
        for k in range(1, n_kf):
            p = int(smap.parent[k])
            if p >= 0:
                pairs.add((min(k, p), max(k, p)))
        a, b = np.where(covis >= self.cfg.loop.covisibility_weight_strong)
        pairs.update((int(x), int(y)) for x, y in zip(a, b) if x < y)
        pairs.update((min(x, y), max(x, y)) for x, y in smap.loop_edges)
        base, conn = sorted(pairs), sorted(loop_pairs)
        ij = np.asarray(base + conn, np.int64).reshape(-1, 2)
        # rows of the stacked poses: the snapshot, then the corrected ones
        off = np.repeat([0, n_kf], [len(base), len(conn)])
        dev = smap.device
        ra, rb = upload(ij[:, 0] + off, dev), upload(ij[:, 1] + off, dev)
        s, R, t = (torch.cat([x, y]) for x, y in zip(snap, corr))
        sm, Rm, tm = sim3.compose(s[ra], R[ra], t[ra],
                                  *sim3.inverse(s[rb], R[rb], t[rb]))
        # the new loop edge: S_kf_corrected o S_loop^-1 = g12
        gs, gR, gt = (x.to(device=dev, dtype=torch.float32) for x in g12)
        ij = np.concatenate([ij, [[kf, loop_kf]]])
        return pose_graph.Sim3Edges(
            i=upload(ij[:, 0], dev), j=upload(ij[:, 1], dev),
            s_meas=torch.cat([sm, gs.reshape(1)]),
            R_meas=torch.cat([Rm, gR[None]]),
            t_meas=torch.cat([tm, gt[None]]),
            valid=torch.ones(len(ij), dtype=torch.bool, device=dev))

    def _solve_graph(self, corr, edges: pose_graph.Sim3Edges, loop_kf: int):
        """optimize_essential_graph with the loop keyframe fixed, seeded
        with the corrected poses, in true float32: keyframe-block sharded
        over mesh.model_parallel devices when there are that many
        (parallel/dist_pose_graph.py), else on one device."""
        s, R, t = corr
        n_shards = self.cfg.mesh.model_parallel
        fixed = torch.arange(s.shape[0], device=s.device) == loop_kf
        n_iters = self.cfg.solver.essential_graph_iters
        if n_shards > 1 and hostmesh.device_count(s.device.type) >= n_shards:
            s_new, R_new, t_new, _ = \
                dist_pose_graph.optimize_essential_graph_dist(
                    s, R, t, fixed, edges, n_iters=n_iters,
                    n_shards=n_shards, axis=self.cfg.mesh.model_axis)
            return s_new, R_new, t_new
        with true_fp32():
            s_new, R_new, t_new, _ = pose_graph.optimize_essential_graph(
                s, R, t, fixed, edges, n_iters=n_iters)
        return s_new, R_new, t_new

    def _remap(self, smap: mapstore.SlamMap, snap, corr, new,
               corrected_by: np.ndarray):
        """Re-map every valid landmark through its reference keyframe:
        the propagation's landmarks through their correcting member's
        propagated pose as the old pose (mnCorrectedReference,
        Optimizer.cc:752-767), the rest through their reference keyframe's
        snapshot pose; then write the optimized poses."""
        st = smap.state
        dev = smap.device
        n_kf = snap[0].shape[0]
        touched = upload(corrected_by >= 0, dev)
        ref = torch.where(touched,
                          upload(corrected_by.astype(np.int64), dev),
                          torch.clamp(st.mp_ref_kf.long(), 0, n_kf - 1))
        s_old, R_old, t_old = (
            torch.where(touched.reshape((-1,) + (1,) * (x.dim() - 1)),
                        y[ref], x[ref]) for x, y in zip(snap, corr))
        s_new, R_new, t_new = new
        Xc = sim3.transform(s_old, R_old, t_old, st.mp_pos)
        new_pos = sim3.transform(*sim3.inverse(s_new[ref], R_new[ref],
                                               t_new[ref]), Xc)
        self._write_pose_tables(
            smap, s_new, R_new, t_new,
            torch.where(st.mp_valid[:, None], new_pos, st.mp_pos))

    def _search_and_fuse(self, smap: mapstore.SlamMap, kf: int,
                         loop_kf: int):
        """SearchAndFuse (LoopClosing.cc:505-527, :572-586): after the
        propagation, project the landmarks of the loop keyframe and its
        top-5 covisible keyframes into kf and its top-5 and merge the
        duplicates (the revisit mapped the region twice; fusing stitches
        the two sheets together), on one host working copy committed once
        through set_kf_obs / set_mp_valid."""
        lm = LocalMapper(cfg=self.cfg, cam=self.cam)
        w = lm._covis_row_np(smap, kf)
        cur_side = [kf] + [int(k) for k in np.argsort(-w)[:5] if w[k] > 0]
        w2 = lm._covis_row_np(smap, loop_kf)
        loop_side = [loop_kf] + [int(k) for k in np.argsort(-w2)[:5]
                                 if w2[k] > 0]
        obs_l = smap.obs_np[loop_side]
        cand = np.unique(obs_l[obs_l >= 0])
        ctx = dict(obs=smap.obs_np.copy(), mp_valid=smap.mp_valid_np.copy(),
                   changed=False)
        for tgt in cur_side:
            lm._fuse_candidates_into(smap, tgt, cand, ctx)
        if ctx["changed"]:
            smap.set_kf_obs(ctx["obs"])
            smap.set_mp_valid(ctx["mp_valid"])

