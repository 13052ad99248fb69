"""Keyframe database: loop and relocalisation candidate retrieval (port of
``orb_slam_tpu.place.database``).

Replaces KeyFrameDatabase (src/KeyFrameDatabase.cc) as the JAX package
does: one SparseBow row per keyframe ([max_kf, W] sorted word ids and
weights, W = max keypoints per frame), and a query is one offset-flattened
searchsorted against every row, independent of the vocabulary size.  It
lives on the host (numpy): queries are keyframe-rate sparse bookkeeping.
Selection semantics:

  DetectLoopCandidates (KeyFrameDatabase.cc:75-196):
    1. count shared words with every keyframe, excluding the query's
       covisibility neighbourhood;
    2. keep keyframes with sharedWords > 0.8 * maxCommonWords and L1
       similarity >= minScore;
    3. accumulate scores over each candidate's top-10 covisibility group
       and keep those above 0.75 * bestAccumulated.

  DetectRelocalisationCandidates (:198-308): the same without the minScore
  gate and without excluded neighbours.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .vocabulary import PAD_ID, SparseBow, score_l1_many_np


class BowDatabase(NamedTuple):
    ids: np.ndarray       # [max_kf, W] int32 sorted word ids (pad PAD_ID)
    w: np.ndarray         # [max_kf, W] float32 L1-normalized weights
    has_row: np.ndarray   # [max_kf] bool

    @staticmethod
    def create(max_kf: int, width: int) -> "BowDatabase":
        return BowDatabase(
            ids=np.full((max_kf, width), np.int32(PAD_ID), np.int32),
            w=np.zeros((max_kf, width), np.float32),
            has_row=np.zeros(max_kf, bool),
        )

    # add/remove write in place and return self: the LoopCloser owns the
    # database alone (the worker writes; the tracker reads only with the
    # worker idle), and copying the [max_kf, W] tables per keyframe would
    # be O(K * W) host work

    def add(self, kf_id: int, bow: SparseBow) -> "BowDatabase":
        self.ids[kf_id] = np.asarray(bow.ids)
        self.w[kf_id] = np.asarray(bow.weights)
        self.has_row[kf_id] = True
        return self

    def remove(self, kf_id: int) -> "BowDatabase":
        self.ids[kf_id] = np.int32(PAD_ID)
        self.w[kf_id] = 0.0
        self.has_row[kf_id] = False
        return self

    def grown(self, max_kf: int) -> "BowDatabase":
        """Re-padded to a larger keyframe capacity (pool growth; ids
        stable)."""
        pad = max_kf - self.ids.shape[0]
        if pad <= 0:
            return self
        W = self.ids.shape[1]
        return BowDatabase(
            ids=np.concatenate(
                [self.ids, np.full((pad, W), np.int32(PAD_ID), np.int32)]),
            w=np.concatenate([self.w, np.zeros((pad, W), np.float32)]),
            has_row=np.concatenate([self.has_row, np.zeros(pad, bool)]),
        )

    def row(self, kf_id: int) -> SparseBow:
        return SparseBow(ids=self.ids[kf_id], weights=self.w[kf_id])

    def __len__(self) -> int:
        """Keyframes with a row."""
        return int(self.has_row.sum())


def query_scores(db: BowDatabase, bow: SparseBow):
    """(shared word counts [K], L1 scores [K]) against every keyframe."""
    scores, shared = score_l1_many_np(bow, db.ids, db.w)
    return (shared * db.has_row,
            np.where(db.has_row, scores, -1.0))


def detect_candidates(
    db: BowDatabase,
    bow: SparseBow,
    exclude: np.ndarray,
    covis_weights: np.ndarray,
    min_score: float | None,
    shared_ratio: float = 0.8,
    acc_ratio: float = 0.75,
    top_group: int = 10,
) -> np.ndarray:
    """DetectLoop/DetectRelocalisationCandidates.

    exclude: [K] bool, keyframes never returned (the query and its
    covisible neighbourhood for loops; none for relocalisation).
    covis_weights: [K, K] covisibility weights for group accumulation.
    Returns candidate keyframe ids, best accumulated score first."""
    shared, scores = query_scores(db, bow)
    shared = np.where(exclude, 0, shared)

    max_common = shared.max()
    if max_common == 0:
        return np.asarray([], np.int64)
    min_common = shared_ratio * max_common
    ok = (shared > min_common) & (shared > 0)
    if min_score is not None:
        ok &= scores >= min_score
    cand = np.where(ok)[0]
    if len(cand) == 0:
        return np.asarray([], np.int64)

    # covisibility-group accumulated score (KeyFrameDatabase.cc:138-176):
    # each candidate sums the scores of itself and of its top-10 covisible
    # keyframes that are candidates too; the group's best member stands
    # for the group.  One argpartition over the candidate rows.
    K = covis_weights.shape[0]
    Wc = np.asarray(covis_weights)[cand]                  # [C, K]
    tg = min(top_group, K - 1) if K > 1 else 0
    if tg > 0:
        top = np.argpartition(-Wc, kth=tg - 1, axis=1)[:, :tg]   # [C, tg]
        wtop = np.take_along_axis(Wc, top, axis=1)
        members = np.concatenate(
            [cand[:, None], np.where(wtop > 0, top, -1)], axis=1)  # [C, 1+tg]
    else:
        members = cand[:, None]
    ok_m = (members >= 0) & ok[np.clip(members, 0, None)]
    sc = np.where(ok_m, scores[np.clip(members, 0, None)], 0.0)
    acc_scores = sc.sum(axis=1)
    # column 0 is the candidate itself (always ok): zero-score ties
    # resolve to it
    best_of_group = members[np.arange(len(cand)), sc.argmax(axis=1)]
    keep = acc_scores >= acc_ratio * acc_scores.max()
    # ranked by accumulated score, best first, deduplicated keeping rank:
    # callers cut the list
    order = np.argsort(-acc_scores[keep], kind="stable")
    ranked = best_of_group[keep][order]
    _, first = np.unique(ranked, return_index=True)
    return ranked[np.sort(first)]
