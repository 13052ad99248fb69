"""Place recognition on the CPU: the port's vocabulary and keyframe
database against the JAX package's.

Tolerances, and why:
  - the vocabulary copy is byte-equal to the JAX package's file;
  - training from one seed gives the same tree, every array exact (both
    are the same numpy k-medians on a numpy Generator);
  - word ids and shared-word counts exact; BoW weights and L1 scores within
    1e-6 (float32 sums in another order);
  - ORBvoc text and npz round trips exact, files written by either package
    read by the other;
  - the database's add / remove / grown / row exact, and detect_candidates
    the same ordered list (host numpy on the same rows).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam_tpu.place import database as jdb
from orb_slam_tpu.place import vocabulary as jvoc
from orb_slam_tpu_torch.place import database as tdb
from orb_slam_tpu_torch.place import vocabulary as tvoc
from test_orbvoc_loader import write_tiny_voc
from test_place import flip, rand_desc
from torch_port_util import np_of

W_TOL = 1e-6


def _same_voc(t, j):
    assert (t.k, t.depth, t.n_words) == (j.k, j.depth, j.n_words)
    np.testing.assert_array_equal(np_of(t.children), np.asarray(j.children))
    np.testing.assert_array_equal(np_of(t.node_desc).view(np.uint32),
                                  np.asarray(j.node_desc))
    np.testing.assert_array_equal(np_of(t.word_id), np.asarray(j.word_id))
    np.testing.assert_array_equal(np_of(t.weights), np.asarray(j.weights))


def _same_bow(t, j):
    np.testing.assert_array_equal(np_of(t.ids), np.asarray(j.ids))
    np.testing.assert_allclose(np_of(t.weights), np.asarray(j.weights),
                               atol=W_TOL, rtol=0)


def _t(a):
    """int32 view tensor of a uint32 descriptor table."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


@pytest.fixture(scope="module")
def vocs():
    """A vocabulary trained in both packages from one corpus (with idf
    weights), and the shipped 10^4-word one."""
    rng = np.random.default_rng(5)
    corpus = rand_desc(rng, 3000)
    docs = rng.integers(0, 40, 3000)
    return dict(
        trained=(tvoc.train(corpus, k=8, depth=3, seed=3, doc_ids=docs),
                 jvoc.train(corpus, k=8, depth=3, seed=3, doc_ids=docs)),
        prebuilt=(tvoc.prebuilt(), jvoc.prebuilt()))


def test_vocabulary_copy_byte_equal():
    """The port reads its own copy, byte-equal to the JAX package's."""
    import os
    port_dir = os.path.dirname(os.path.dirname(os.path.abspath(
        tvoc.__file__)))
    assert os.path.abspath(tvoc._PREBUILT_PATH).startswith(port_dir + os.sep)
    with open(tvoc._PREBUILT_PATH, "rb") as f:
        port = f.read()
    with open(jvoc._PREBUILT_PATH, "rb") as f:
        ref = f.read()
    assert port == ref and len(port) > 300_000


@pytest.mark.parametrize("doc_ids", [False, True])
def test_train_same_tree(doc_ids, rng):
    corpus = rand_desc(rng, 2500)
    docs = rng.integers(0, 30, 2500) if doc_ids else None
    t = tvoc.train(corpus, k=6, depth=3, seed=11, doc_ids=docs)
    j = jvoc.train(corpus, k=6, depth=3, seed=11, doc_ids=docs)
    assert t.n_words > 100
    _same_voc(t, j)
    # the port's trainer also takes int32 views of the words
    _same_voc(tvoc.train(corpus.view(np.int32), k=6, depth=3, seed=11,
                         doc_ids=docs), j)


@pytest.mark.parametrize("which", ["trained", "prebuilt"])
def test_transform_host_and_tensor_match_jax(which, vocs, rng):
    tv, jv = vocs[which]
    d = rand_desc(rng, 300)
    d[150:] = flip(rng, d[:150], 3)          # repeated words
    valid = rng.random(300) < 0.9
    jb = jvoc.transform(jv, jnp.asarray(d), jnp.asarray(valid))
    jb_np = jvoc.transform_np(jv, d, valid)
    _same_bow(jb_np, jb)                      # the reference's two paths
    _same_bow(tvoc.transform_np(tv, d, valid), jb_np)
    _same_bow(tvoc.transform_np(tv, d.view(np.int32), valid), jb_np)
    tb = tvoc.transform(tv, _t(d), torch.from_numpy(valid))
    _same_bow(tb, jb)
    np.testing.assert_array_equal(
        np_of(tvoc.transform_words(tv, _t(d))),
        np.asarray(jvoc.transform_words(jv, jnp.asarray(d))))
    np.testing.assert_allclose(np_of(tvoc.densify(tv, tb)),
                               np.asarray(jvoc.densify(jv, jb)), atol=W_TOL)
    # an empty frame: all pads, zero weights
    none = np.zeros(300, bool)
    _same_bow(tvoc.transform_np(tv, d, none), jvoc.transform_np(jv, d, none))


@pytest.mark.parametrize("which", ["trained", "prebuilt"])
def test_scores_match_jax(which, vocs, rng):
    tv, jv = vocs[which]
    scenes = [rand_desc(rng, 200) for _ in range(4)]
    query = flip(rng, scenes[1], 5)
    ones = np.ones(200, bool)
    jq = jvoc.transform_np(jv, query, ones)
    jrows = [jvoc.transform_np(jv, s, ones) for s in scenes]
    tq = tvoc.transform_np(tv, query, ones)
    trows = [tvoc.transform_np(tv, s, ones) for s in scenes]
    for tr, jr in zip(trows, jrows):
        assert tvoc.score_l1_np(tq, tr) == pytest.approx(
            jvoc.score_l1_np(jq, jr), abs=W_TOL)
    ids = np.stack([r.ids for r in jrows])
    w = np.stack([r.weights for r in jrows])
    js, jshared = jvoc.score_l1_many_np(jq, ids, w)
    ts, tshared = tvoc.score_l1_many_np(tq, ids, w)
    np.testing.assert_allclose(ts, js, atol=W_TOL)
    np.testing.assert_array_equal(tshared, jshared)
    assert np.argmax(ts) == 1       # the revisited scene scores highest
    # the tensor versions
    jqd = jvoc.SparseBow(jnp.asarray(jq.ids), jnp.asarray(jq.weights))
    tqd = tvoc.SparseBow(torch.from_numpy(jq.ids),
                         torch.from_numpy(jq.weights))
    js2, jsh2 = jvoc.score_l1_many(jqd, jnp.asarray(ids), jnp.asarray(w))
    ts2, tsh2 = tvoc.score_l1_many(tqd, torch.from_numpy(ids),
                                   torch.from_numpy(w))
    np.testing.assert_allclose(np_of(ts2), np.asarray(js2), atol=W_TOL)
    np.testing.assert_array_equal(np_of(tsh2), np.asarray(jsh2))
    row = tvoc.SparseBow(torch.from_numpy(ids[2]), torch.from_numpy(w[2]))
    jrow = jvoc.SparseBow(jnp.asarray(ids[2]), jnp.asarray(w[2]))
    assert float(tvoc.score_l1(tqd, row)) == pytest.approx(
        float(jvoc.score_l1(jqd, jrow)), abs=W_TOL)


def test_orbvoc_text_round_trips(tmp_path, vocs, rng):
    """The reference's text format: a file written by hand, and files
    written by each package, read by both."""
    p = str(tmp_path / "tiny.txt")
    write_tiny_voc(p, rng=rng)
    _same_voc(tvoc.load_orbvoc_text(p), jvoc.load_orbvoc_text(p))
    tv, jv = vocs["trained"]
    pt, pj = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    tvoc.save_orbvoc_text(tv, pt)
    jvoc.save_orbvoc_text(jv, pj)
    with open(pt) as a, open(pj) as b:
        assert a.read() == b.read()
    _same_voc(tvoc.load_orbvoc_text(pt), jvoc.load_orbvoc_text(pt))


def test_npz_round_trips(tmp_path, vocs):
    tv, jv = vocs["trained"]
    pt, pj = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tvoc.save_npz(tv, pt)
    jvoc.save_npz(jv, pj)
    _same_voc(tvoc.load_npz(pj), jvoc.load_npz(pt))
    _same_voc(tvoc.load_npz(pt), jv)
    _same_voc(tvoc.prebuilt(), jvoc.prebuilt())


def _same_db(t, j):
    np.testing.assert_array_equal(t.ids, j.ids)
    np.testing.assert_array_equal(t.w, j.w)
    np.testing.assert_array_equal(t.has_row, j.has_row)


def test_database_ops_exact(vocs, rng):
    tv, jv = vocs["prebuilt"]
    K, W = 6, 120
    t, j = tdb.BowDatabase.create(K, W), jdb.BowDatabase.create(K, W)
    _same_db(t, j)
    for k in (0, 2, 3, 5):
        d = rand_desc(rng, W)
        valid = rng.random(W) < 0.8
        t = t.add(k, tvoc.transform_np(tv, d, valid))
        j = j.add(k, jvoc.transform_np(jv, d, valid))
    _same_db(t, j)
    t, j = t.remove(3), j.remove(3)
    _same_db(t, j)
    assert len(t) == 3
    t, j = t.grown(10), j.grown(10)
    _same_db(t, j)
    assert t.ids.shape == (10, W)
    _same_bow(t.row(2), j.row(2))
    assert t.grown(4) is t


def _db_pair(tv, jv, scenes, width):
    K = len(scenes)
    t, j = tdb.BowDatabase.create(K + 2, width), jdb.BowDatabase.create(
        K + 2, width)
    ones = np.ones(width, bool)
    for k, s in enumerate(scenes):
        t = t.add(k, tvoc.transform_np(tv, s, ones))
        j = j.add(k, jvoc.transform_np(jv, s, ones))
    return t, j


@pytest.mark.parametrize("case", ["loop", "reloc", "empty", "groups"])
def test_detect_candidates_same_list(case, vocs, rng):
    """The cases of tests/test_place.py (a loop query with an excluded
    neighbourhood, a relocalisation query, an empty database) and one with
    covisibility groups: the same ordered candidate list."""
    tv, jv = vocs["trained"]
    width = 150
    n_scenes = 0 if case == "empty" else 10
    scenes = [rand_desc(rng, width) for _ in range(n_scenes)]
    t, j = _db_pair(tv, jv, scenes, width)
    K = len(t.has_row)
    exclude = np.zeros(K, bool)
    covis = np.zeros((K, K))
    min_score = None
    target = rand_desc(rng, width) if case == "empty" else flip(
        rng, scenes[2], 5)
    if case == "loop":
        exclude[8:] = True
        min_score = 0.01
    if case == "groups":
        # scenes 2-4 and 6-7 revisit each other's words and are covisible
        for a, b in ((3, 2), (4, 2), (7, 6)):
            scenes[a][:90] = flip(rng, scenes[b][:90], 6)
        t, j = _db_pair(tv, jv, scenes, width)
        for grp in ((2, 3, 4), (6, 7)):
            for a in grp:
                for b in grp:
                    covis[a, b] = 0 if a == b else 20 + a + b
        target = flip(rng, scenes[3], 4)
    ones = np.ones(width, bool)
    tq = tvoc.transform_np(tv, target, ones)
    jq = jvoc.transform_np(jv, target, ones)
    tc = tdb.detect_candidates(t, tq, exclude, covis, min_score=min_score)
    jc = jdb.detect_candidates(j, jq, exclude, covis, min_score=min_score)
    np.testing.assert_array_equal(tc, jc)
    if case == "empty":
        assert len(tc) == 0
    else:
        assert 2 in tc or 3 in tc
    np.testing.assert_array_equal(tdb.query_scores(t, tq)[0],
                                  jdb.query_scores(j, jq)[0])
