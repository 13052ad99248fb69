"""The port's vocabulary trainer (``scripts/torch_train_vocabulary.py``)
against the JAX package's (``scripts/train_vocabulary.py``), on the CPU.

Tolerances, and why:
  - the training images: equal (the same renderer copied, the same seed);
  - the tree trained on one descriptor table in both packages: children,
    node descriptors, word ids and idf weights equal (both train in numpy
    from the same seed);
  - the front end's descriptors of one image: the same keypoints, and
    descriptors <= 2 bits per keypoint and equal on >= 99% of them (the
    bounds of ``tests/test_torch_extract_per_level.py``).  The image is a
    240x320 crop of a training image, to keep the file short.
"""
import os
import sys

import numpy as np
import pytest
import torch

from orb_slam_tpu.config import ExtractorConfig as JExt
from orb_slam_tpu.place import vocabulary as jvoc
from orb_slam_tpu_torch.place import vocabulary as tvoc
from torch_port_util import desc_bits, np_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import torch_train_vocabulary as twin  # noqa: E402
import train_vocabulary as jtrain  # noqa: E402

CROP = (slice(0, 240), slice(0, 320))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's ops on one thread: under the suite's parallel workers a
    full intra-op pool per worker oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def images():
    rng_t, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    out = []
    for _ in range(2):
        a, b = twin.render_patch_world(rng_t), jtrain.render_patch_world(rng_j)
        np.testing.assert_array_equal(a, b)
        out.append(a[CROP])
    return out


@pytest.fixture(scope="module")
def port_descs(images):
    return [twin.extract_descs(img, device="cpu") for img in images]


def test_extract_descs_matches_jax(images, port_descs):
    jcfg = JExt(n_features=1000, max_keypoints=1024, n_levels=8)
    j = np_of(jtrain.extract_descs(images[0], jcfg))
    t = port_descs[0]
    assert t.dtype == np.int32 and t.shape == j.shape, (t.shape, j.shape)
    assert len(t) > 300
    bits = desc_bits(t, j)
    assert bits.max() <= 2, bits.max()
    assert (bits == 0).mean() >= 0.99, (bits == 0).mean()


def test_tree_equals_jax(port_descs):
    corpus = np.concatenate(port_descs).view(np.uint32)
    doc = np.concatenate([np.full(len(d), i)
                          for i, d in enumerate(port_descs)])
    t = tvoc.to_numpy(tvoc.train(corpus, k=6, depth=3, doc_ids=doc))
    j = jvoc.to_numpy(jvoc.train(corpus, k=6, depth=3, doc_ids=doc))
    assert (t.k, t.depth, t.n_words) == (j.k, j.depth, j.n_words)
    assert t.n_words > 50
    np.testing.assert_array_equal(t.children, j.children)
    np.testing.assert_array_equal(np.asarray(t.node_desc).view(np.uint32),
                                  np.asarray(j.node_desc).view(np.uint32))
    np.testing.assert_array_equal(t.word_id, j.word_id)
    np.testing.assert_array_equal(t.weights, j.weights)


def test_augment_equals_jax_script(port_descs):
    """The twin's --augment flips the bits the JAX script flips."""
    corpus = np.concatenate(port_descs).view(np.uint32)
    doc = np.zeros(len(corpus), np.int64)
    c, d = twin.augment(corpus, doc, 2, 2, np.random.default_rng(5))
    rng = np.random.default_rng(5)
    assert len(c) == 3 * len(corpus) and d.max() == 4
    # the JAX script's loop, inline (it lives in its main())
    want = [corpus]
    for _ in range(2):
        x = corpus.copy()
        flips = rng.integers(2, 6, size=len(x))
        bits = rng.integers(0, 256, size=(len(x), 5))
        for b in range(5):
            m = flips > b
            x[np.where(m)[0], bits[m, b] // 32] ^= (
                np.uint32(1) << (bits[m, b] % 32).astype(np.uint32))
        want.append(x)
    np.testing.assert_array_equal(c, np.concatenate(want))


def test_main_writes_a_vocabulary_and_spares_the_shipped_one(tmp_path,
                                                             monkeypatch):
    shipped = os.path.join(ROOT, "orb_slam_tpu_torch", "data",
                           "vocab10k.npz")
    before = open(shipped, "rb").read()
    with pytest.raises(SystemExit):
        twin.main(["--out", shipped, "--images", "1", "--device", "cpu"])
    # one small image keeps the run short: the renderer is patched here
    monkeypatch.setattr(twin, "render_patch_world",
                        lambda rng: jtrain.render_patch_world(rng)[CROP])
    out = tmp_path / "voc.npz"
    assert twin.main(["--out", str(out), "--images", "2", "--k", "4",
                      "--depth", "2", "--device", "cpu"]) == 0
    voc = tvoc.load_npz(str(out))
    assert voc.k == 4 and voc.depth == 2 and voc.n_words > 4
    assert open(shipped, "rb").read() == before
