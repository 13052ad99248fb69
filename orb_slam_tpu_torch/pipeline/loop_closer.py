"""Place recognition at keyframe rate (port of the detection half of
``orb_slam_tpu.pipeline.loop_closer``).

The LoopClosing thread of the reference (src/LoopClosing.cc) per new
keyframe:
  1. DetectLoop (:99-229): BoW candidates gated by a minimum score against
     the covisible neighbourhood and by covisibility consistency across 3
     consecutive keyframes;
  2. ComputeSim3 (:231-406) and 3. CorrectLoop (:408-570).

This slice ports step 1 and the state it keeps: the vocabulary, the
keyframe database, one BoW row per keyframe, the consistent groups.
Steps 2-3 (Sim3 RANSAC, the essential-graph optimization, loop fusion)
come with the loop-closing slice: where detection returns candidates,
``process_keyframe`` stops and reports them as ``loop_unchecked``.  The
tracker's relocalisation reads the same vocabulary and database.

Everything here is host numpy: the BoW transform reads the keyframe rows'
host mirrors, covisibility comes from the observation mirror through the
compiled graph ops, so a keyframe costs no device read here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import native
from ..config import SystemConfig
from ..geometry.camera import CameraParams
from ..mapping import mapstore
from ..place import database as db_mod
from ..place import vocabulary as voc_mod
from ..utils.timing import GLOBAL_TIMER as _timer


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
        """Add the keyframe to the database and run loop detection.
        Consistent candidates are reported (``loop_candidates``, and
        ``loop_unchecked``: the solvers of the geometric check and the
        correction exist (``solvers/{sim3_solver,sim3_opt,pose_graph}``),
        but their wiring into the loop closer is the next slice)."""
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
        if len(cand):
            metrics["loop_unchecked"] = len(cand)
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
