"""Bag-of-words vocabulary (port of ``orb_slam_tpu.place.vocabulary``).

Replaces DBoW2's TemplatedVocabulary (Thirdparty/DBoW2/DBoW2/
TemplatedVocabulary.h), as the JAX package does:

  * the k-ary tree is dense arrays (a children table and packed 256-bit
    centroid descriptors), and the descent of all N descriptors of a frame
    is level-synchronous: one gather and one Hamming argmin per level;
  * a BoW vector is a sparse fixed-width row: sorted (word id, weight)
    pairs of width N (pad id PAD_ID, pad weight 0), L1-normalized, and two
    vectors score by a sorted merge (searchsorted), so a 10^4- and a
    10^6-word vocabulary cost the same per query.

Two versions of the transform and the scores: the numpy host path
(``transform_np``, ``score_l1_np``, ``score_l1_many_np``), which the
tracker and the loop closer use (place recognition is keyframe-rate sparse
bookkeeping over ~1000-wide rows, so it stays on the host, as in the JAX
package), and functions on tensors (``transform``, ``score_l1``,
``score_l1_many``, ``densify``) that run where the vocabulary's tensors
are.  Descriptors are int32 views of the uint32 words, as everywhere in
the port; the numpy path works on uint32 views.

Training (hierarchical binary k-medians + TF-IDF, TemplatedVocabulary::
create + setNodeWeights) stays numpy on a numpy Generator, so a seed gives
the JAX package's tree exactly.  The shipped 10^4-word vocabulary is the
port's own copy, ``data/vocab10k.npz`` (``tests/test_torch_place.py``
holds it byte-equal to the JAX package's file); larger vocabularies load
by path (``load_npz``, ``load_orbvoc_text``).
"""
from __future__ import annotations

import os
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.match import _popcount32

_POP8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint8)

# pad word id of empty SparseBow slots: above any real word id and the same
# for every vocabulary, so shared-word counting masks pads by id alone
PAD_ID = 2**30


class Vocabulary(NamedTuple):
    """Dense k-ary vocabulary tree over packed 256-bit descriptors."""

    children: torch.Tensor   # [n_nodes, k] int32 child node ids (-1 none)
    node_desc: torch.Tensor  # [n_nodes, 8] int32 centroid descriptors
    word_id: torch.Tensor    # [n_nodes] int32 leaf word id (-1 internal)
    weights: torch.Tensor    # [n_words + 1] float32 IDF weights (pad 0)
    k: int
    depth: int
    n_words: int


class SparseBow(NamedTuple):
    """L1-normalized TF-IDF vector as sorted (word id, weight) pairs.

    ids: [W] int32 ascending, padded with PAD_ID (weight 0).
    weights: [W] float32, summing to 1 over real entries (0 if empty).
    numpy arrays on the host path, tensors from ``transform``."""

    ids: object
    weights: object


def _u32(desc) -> np.ndarray:
    """uint32 view of a descriptor table (int32 views of the words in)."""
    d = np.asarray(desc)
    return d.view(np.uint32) if d.dtype == np.int32 else d


def _make(children, node_desc, word_id, weights, k, depth, n_words
          ) -> Vocabulary:
    """A tensor Vocabulary from numpy arrays (descriptors as int32 views)."""
    return Vocabulary(
        children=torch.from_numpy(np.array(children, np.int32)),
        node_desc=torch.from_numpy(
            np.ascontiguousarray(node_desc, np.uint32).view(np.int32).copy()),
        word_id=torch.from_numpy(np.array(word_id, np.int32)),
        weights=torch.from_numpy(np.array(weights, np.float32)),
        k=int(k), depth=int(depth), n_words=int(n_words))


# ----------------------------------------------------------------------
# training (numpy, as the JAX package)
# ----------------------------------------------------------------------

def _popcount_rows(x: np.ndarray) -> np.ndarray:
    """Hamming weight over the last (packed-u32) axis via a byte LUT."""
    b = np.ascontiguousarray(x).view(np.uint8)
    return _POP8[b].reshape(*x.shape[:-1], -1).sum(-1, dtype=np.int32)


def _majority_center(desc: np.ndarray) -> np.ndarray:
    """Bitwise majority vote (FORB::meanValue, FORB.cpp:28-77)."""
    bits = np.unpackbits(desc.view(np.uint8), axis=-1)  # [n, 256]
    maj = (bits.sum(0) * 2 >= len(bits)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians(desc: np.ndarray, k: int, rng, iters: int = 8,
              fit_cap: int = 60_000) -> np.ndarray:
    """Binary k-medians: Hamming assignment + majority-vote centres, Lloyd
    iterations on at most `fit_cap` sampled rows."""
    n = len(desc)
    fit = desc if n <= fit_cap else desc[rng.choice(n, fit_cap, replace=False)]
    centers = fit[rng.choice(len(fit), size=min(k, len(fit)),
                             replace=False)].copy()
    for _ in range(iters):
        d = _popcount_rows(fit[:, None, :] ^ centers[None, :, :])
        assign = d.argmin(1)
        for c in range(len(centers)):
            sel = assign == c
            if sel.sum() > 0:
                centers[c] = _majority_center(fit[sel])
    return centers


def train(descriptors: np.ndarray, k: int = 10, depth: int = 4,
          seed: int = 0, doc_ids: Optional[np.ndarray] = None) -> Vocabulary:
    """Hierarchical binary k-medians (TemplatedVocabulary::create).

    descriptors: [M, 8] uint32 (or int32 views).  doc_ids: optional [M]
    document index per descriptor; when given, word weights are the idf
    log(N_docs / N_docs_with_word) of setNodeWeights
    (TemplatedVocabulary.h:315-364), otherwise uniform."""
    descriptors = _u32(descriptors)
    rng = np.random.default_rng(seed)
    max_nodes = sum(k**l for l in range(depth + 1))
    children = np.full((max_nodes, k), -1, np.int32)
    node_desc = np.zeros((max_nodes, 8), np.uint32)
    n_nodes = 1  # root = 0

    queue = deque([(0, descriptors, 0)])
    leaves = []
    while queue:
        node, data, level = queue.popleft()
        if level == depth or len(data) <= 1:
            leaves.append(node)
            continue
        centers = _kmedians(data, k, rng)
        d = _popcount_rows(data[:, None, :] ^ centers[None, :, :])
        assign = d.argmin(1)
        for c in range(len(centers)):
            sel = assign == c
            if not sel.any():
                continue
            cid = n_nodes
            n_nodes += 1
            children[node, c] = cid
            node_desc[cid] = centers[c]
            queue.append((cid, data[sel], level + 1))

    word_id = np.full(max_nodes, -1, np.int32)
    for w, leaf in enumerate(leaves):
        word_id[leaf] = w
    n_words = len(leaves)

    if doc_ids is not None:
        # idf from the training corpus (TF_IDF, TemplatedVocabulary.h:340);
        # unseen and fully common words get idf 0, as setNodeWeights
        words = _descend_np(children[:n_nodes], node_desc[:n_nodes],
                            word_id[:n_nodes], depth, descriptors)
        doc_ids = np.asarray(doc_ids)
        n_docs = int(doc_ids.max()) + 1
        seen = np.zeros((n_words,), np.int64)
        m = words >= 0
        pairs = np.unique(
            doc_ids[m].astype(np.int64) * n_words + words[m])
        np.add.at(seen, (pairs % n_words).astype(np.int64), 1)
        weights = np.where(
            seen > 0, np.log(n_docs / np.maximum(seen, 1)), 0.0
        ).astype(np.float32)
    else:
        weights = np.ones(n_words, np.float32)

    return _make(children[:n_nodes], node_desc[:n_nodes], word_id[:n_nodes],
                 np.concatenate([weights, [0.0]]).astype(np.float32),
                 k, depth, n_words)


def _descend_np(children, node_desc, word_id, depth, desc: np.ndarray,
                chunk: int = 200_000):
    """Host batched tree descent, chunked so the [N, k, 32]-byte
    temporaries stay bounded for 10^6-row corpora."""
    out = np.empty(len(desc), np.int32)
    for lo in range(0, len(desc), chunk):
        d = desc[lo:lo + chunk]
        node = np.zeros(len(d), np.int32)
        for _ in range(depth):
            ch = children[node]                               # [N, k]
            cd = node_desc[np.clip(ch, 0, None)]              # [N, k, 8]
            dist = _popcount_rows(d[:, None, :] ^ cd)
            dist = np.where(ch >= 0, dist, 1 << 20)
            best = dist.argmin(1)
            nxt = ch[np.arange(len(d)), best]
            node = np.where(nxt >= 0, nxt, node)
        out[lo:lo + chunk] = word_id[node]
    return out


# ----------------------------------------------------------------------
# transform and scores on tensors
# ----------------------------------------------------------------------

def transform_words(voc: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """Descriptors [N, 8] int32 -> word ids [N] int32.  A descriptor stuck
    at a childless node stays there (a short branch)."""
    n = desc.shape[0]
    rows = torch.arange(n, device=desc.device)
    node = torch.zeros(n, dtype=torch.int64, device=desc.device)
    for _ in range(voc.depth):
        ch = voc.children[node].to(torch.int64)           # [N, k]
        cd = voc.node_desc[torch.clamp(ch, min=0)]        # [N, k, 8]
        dist = _popcount32(desc[:, None, :] ^ cd).sum(-1)
        dist = torch.where(ch >= 0, dist, torch.full_like(dist, 1 << 20))
        best = torch.argmin(dist, dim=1)
        nxt = ch[rows, best]
        node = torch.where(nxt >= 0, nxt, node)
    return voc.word_id[node]


def transform(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor
              ) -> SparseBow:
    """Descriptors [N, 8] -> SparseBow of width N: descent, dedup of the
    sorted word ids, weight = count * idf, L1 normalization
    (TemplatedVocabulary::transform + BowVector::normalize)."""
    n_words = voc.n_words
    pad = torch.full((), n_words, dtype=torch.int64, device=desc.device)
    words = transform_words(voc, desc).to(torch.int64)
    words = torch.where(valid & (words >= 0), words, pad)
    counts = torch.zeros(n_words + 1, dtype=torch.float32,
                         device=desc.device).index_add_(
        0, words, torch.ones(words.shape[0], device=desc.device))
    sw = torch.sort(words).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=desc.device),
                       sw[1:] != sw[:-1]]) & (sw < pad)
    ids = torch.where(first, sw, pad)
    w = torch.where(first, counts[ids] * voc.weights[ids],
                    torch.zeros((), device=desc.device))
    # dup slots (now pad) go behind the real entries, weights paired
    order = torch.sort(ids, stable=True).indices
    ids, w = ids[order], w[order]
    s = torch.sum(w)
    ids = torch.where(ids == pad, torch.full_like(ids, PAD_ID), ids)
    return SparseBow(ids=ids.to(torch.int32),
                     weights=w / torch.clamp(s, min=1e-9))


def _merge(ai, aw, bi, bw):
    """b's entries aligned onto a's id slots by a sorted merge
    (searchsorted; leading axes batch).  Returns (a weights, b weights,
    shared): the weights restricted to the common-word support, and the
    weight-independent id intersection (DBoW2's shared-word count includes
    idf-0 words, KeyFrameDatabase.cc:75-196)."""
    W = bi.shape[-1]
    idx = torch.clamp(torch.searchsorted(bi.contiguous(), ai.contiguous()),
                      0, W - 1)
    shared = (torch.gather(bi, -1, idx) == ai) & (ai < PAD_ID)
    hit = shared & (aw > 0)
    zero = torch.zeros((), dtype=bw.dtype, device=bw.device)
    bwm = torch.where(hit, torch.gather(bw, -1, idx), zero)
    awm = torch.where(bwm > 0, aw, zero)
    return awm, bwm, shared


def score_l1(a: SparseBow, b: SparseBow) -> torch.Tensor:
    """DBoW2 L1 score in [0, 1] of L1-normalized vectors (L1Scoring):
    1 - 0.5 |a - b|_1 = sum over common words of (a + b - |a - b|) / 2."""
    aw, bw, _ = _merge(a.ids, a.weights, b.ids, b.weights)
    return torch.sum(0.5 * (aw + bw - torch.abs(aw - bw)))


def score_l1_many(a: SparseBow, ids: torch.Tensor, w: torch.Tensor):
    """Scores of `a` against stacked sparse rows ids/w [K, W]: (scores [K],
    shared word counts [K])."""
    K = ids.shape[0]
    ai = a.ids[None, :].expand(K, -1)
    aw = a.weights[None, :].expand(K, -1)
    awm, bwm, shared = _merge(ai, aw, ids, w)
    return (torch.sum(0.5 * (awm + bwm - torch.abs(awm - bwm)), dim=1),
            torch.sum(shared, dim=1))


def densify(voc: Vocabulary, bow: SparseBow) -> torch.Tensor:
    """[n_words] dense vector (tests, small-vocabulary diagnostics)."""
    vec = torch.zeros(voc.n_words + 1, dtype=torch.float32,
                      device=bow.weights.device)
    ids = torch.clamp(bow.ids.to(torch.int64), max=voc.n_words)
    return vec.index_add_(0, ids, bow.weights)[: voc.n_words]


# ----------------------------------------------------------------------
# the host path (numpy): what the tracker and the loop closer run
# ----------------------------------------------------------------------

_np_voc_cache: dict = {}


def to_numpy(voc: Vocabulary) -> Vocabulary:
    """Host copy of the vocabulary arrays, node descriptors as uint32
    (cached by tree identity)."""
    key = id(voc.children)
    ent = _np_voc_cache.get(key)
    if ent is None or ent[0] is not voc.children:
        _np_voc_cache.clear()   # one live vocabulary per process in practice
        ent = (voc.children, Vocabulary(
            children=voc.children.cpu().numpy(),
            node_desc=voc.node_desc.cpu().numpy().view(np.uint32),
            word_id=voc.word_id.cpu().numpy(),
            weights=voc.weights.cpu().numpy(),
            k=voc.k, depth=voc.depth, n_words=voc.n_words))
        _np_voc_cache[key] = ent
    return ent[1]


def transform_np(voc: Vocabulary, desc: np.ndarray, valid: np.ndarray
                 ) -> SparseBow:
    """Host transform: descriptors [N, 8] (uint32 or int32 views) ->
    SparseBow of numpy arrays, the contract of ``transform``."""
    v = to_numpy(voc)
    desc = _u32(desc)
    valid = np.asarray(valid)
    words = _descend_np(v.children, v.node_desc, v.word_id, v.depth, desc)
    pad = np.int32(v.n_words)
    words = np.where(valid & (words >= 0), words, pad)

    counts = np.zeros(v.n_words + 1, np.float32)
    np.add.at(counts, words, 1.0)
    sw = np.sort(words)
    first = np.concatenate([[True], sw[1:] != sw[:-1]]) & (sw < pad)
    ids = np.where(first, sw, pad)
    w = np.where(first, counts[ids] * v.weights[ids], 0.0).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    ids = ids[order]
    w = w[order]
    s = w.sum()
    ids = np.where(ids == pad, np.int32(PAD_ID), ids).astype(np.int32)
    return SparseBow(ids=ids, weights=w / max(s, 1e-9))


def _merge_np(ai, aw, bi, bw):
    W = bi.shape[0]
    idx = np.clip(np.searchsorted(bi, ai), 0, W - 1)
    shared = (bi[idx] == ai) & (ai < PAD_ID)
    hit = shared & (aw > 0)
    bwm = np.where(hit, bw[idx], 0.0)
    awm = np.where(bwm > 0, aw, 0.0)
    return awm, bwm, shared


def score_l1_np(a: SparseBow, b: SparseBow) -> float:
    aw, bw, _ = _merge_np(np.asarray(a.ids), np.asarray(a.weights),
                          np.asarray(b.ids), np.asarray(b.weights))
    return float(np.sum(0.5 * (aw + bw - np.abs(aw - bw))))


def score_l1_many_np(a: SparseBow, ids: np.ndarray, w: np.ndarray):
    """Host scores of `a` against stacked rows ids/w [K, W] in one pass:
    each row is sorted, so a per-row int64 offset makes the flattened ids
    globally sorted and one searchsorted serves every row.  Returns
    (scores [K], shared word counts [K])."""
    K, W = ids.shape
    ai = np.asarray(a.ids).astype(np.int64)
    aw = np.asarray(a.weights)
    off = (np.arange(K, dtype=np.int64) * (1 << 32))[:, None]
    flat = (ids.astype(np.int64) + off).reshape(-1)
    q = (ai[None, :] + off).reshape(-1)
    idx = np.clip(np.searchsorted(flat, q), 0, K * W - 1)
    shared = (flat[idx] == q).reshape(K, W) & (ai[None, :] < PAD_ID)
    hit = shared & (aw[None, :] > 0)
    bwm = np.where(hit, w.reshape(-1)[idx].reshape(K, W), 0.0)
    awm = np.where(bwm > 0, aw[None, :], 0.0)
    scores = np.sum(0.5 * (awm + bwm - np.abs(awm - bwm)), axis=1)
    return scores, shared.sum(axis=1)


# ----------------------------------------------------------------------
# IO: ORBvoc.txt (DBoW2 text format) and npz
# ----------------------------------------------------------------------

def load_orbvoc_text(path: str) -> Vocabulary:
    """Read the ORBvoc.txt format (TemplatedVocabulary.h:1338): a header
    `k L scoring weighting`, then one node per line, `parent_id is_leaf
    descriptor(32 bytes) weight`, in tree order."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        rows = []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parent = int(parts[0])
            is_leaf = bool(int(parts[1]))
            d = np.array([int(x) for x in parts[2:34]], np.uint8)
            w = float(parts[34])
            rows.append((parent, is_leaf, d, w))

    n_nodes = len(rows) + 1
    children = np.full((n_nodes, k), -1, np.int32)
    node_desc = np.zeros((n_nodes, 8), np.uint32)
    word_id = np.full(n_nodes, -1, np.int32)
    weights = []
    child_count = np.zeros(n_nodes, np.int32)
    for i, (parent, is_leaf, d, w) in enumerate(rows):
        nid = i + 1
        slot = child_count[parent]
        if slot < k:
            children[parent, slot] = nid
            child_count[parent] += 1
        node_desc[nid] = d.copy().view(np.uint32)
        if is_leaf:
            word_id[nid] = len(weights)
            weights.append(w)
    return _make(children, node_desc, word_id,
                 np.concatenate([np.asarray(weights, np.float32), [0.0]]),
                 k, L, len(weights))


def save_orbvoc_text(voc: Vocabulary, path: str) -> None:
    """Write the DBoW2 text format (inverse of load_orbvoc_text), nodes in
    BFS order so every parent precedes its children; word ids renumber in
    emission order (scores are invariant to word relabeling)."""
    v = to_numpy(voc)
    children, node_desc, word_id, weights = (v.children, v.node_desc,
                                             v.word_id, v.weights)
    new_id = {0: 0}
    queue = [0]
    order = []
    while queue:
        node = queue.pop(0)
        order.append(node)
        for c in children[node]:
            if c >= 0:
                new_id[int(c)] = len(new_id)
                queue.append(int(c))
    parent_of = np.full(len(children), -1, np.int64)
    for n in range(len(children)):
        for c in children[n]:
            if c >= 0:
                parent_of[c] = n

    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.depth} 0 0\n")
        for node in order[1:]:
            is_leaf = int(word_id[node] >= 0)
            d = node_desc[node].view(np.uint8)
            w = float(weights[word_id[node]]) if is_leaf else 0.0
            f.write(f"{new_id[int(parent_of[node])]} {is_leaf} "
                    + " ".join(str(int(x)) for x in d)
                    + f" {w:.6f}\n")


def save_npz(voc: Vocabulary, path: str) -> None:
    """The JAX package's npz layout (node descriptors as uint32)."""
    v = to_numpy(voc)
    np.savez_compressed(
        path, children=v.children, node_desc=v.node_desc,
        word_id=v.word_id, weights=v.weights,
        meta=np.asarray([voc.k, voc.depth, voc.n_words]))


def load_npz(path: str) -> Vocabulary:
    z = np.load(path)
    k, depth, n_words = (int(x) for x in z["meta"])
    return _make(z["children"], z["node_desc"], z["word_id"], z["weights"],
                 k, depth, n_words)


_PREBUILT_PATH = os.path.join(
    os.path.dirname(__file__), "..", "data", "vocab10k.npz")
_prebuilt_cache: Optional[Vocabulary] = None


def prebuilt() -> Optional[Vocabulary]:
    """The shipped 10^4-word vocabulary (the port's copy), or None if the
    data file is absent."""
    global _prebuilt_cache
    if _prebuilt_cache is None and os.path.exists(_PREBUILT_PATH):
        _prebuilt_cache = load_npz(_PREBUILT_PATH)
    return _prebuilt_cache
