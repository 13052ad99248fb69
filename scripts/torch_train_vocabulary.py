#!/usr/bin/env python3
"""Train a vocabulary tree with the PyTorch/CUDA port's front end: the twin
of ``scripts/train_vocabulary.py`` for ``orb_slam_tpu_torch``.

    python3 scripts/torch_train_vocabulary.py --out vocab.npz \\
        [--images 80] [--k 10] [--depth 4] [--augment 0] [--device cpu]

It renders synthetic patch-world images (its own copy of the JAX script's
``render_patch_world``, the same distribution and seed), runs each through
the port's per-level extractor (FAST + IC angle + steered BRIEF,
``frontend/extractor.py::extract_default``) on ``--device`` (the card
unless the caller names the CPU), and trains a k-ary tree with TF-IDF
weights from the per-image documents (``place/vocabulary.train``), saved
in the JAX package's npz layout (``save_npz``).

``--out`` is required and may not name the shipped vocabulary
(``orb_slam_tpu_torch/data/vocab10k.npz``), which stays byte-equal to the
JAX package's copy.
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SHIPPED = os.path.join(ROOT, "orb_slam_tpu_torch", "data", "vocab10k.npz")


def render_patch_world(rng):
    """One synthetic training image: textured squares on grey + noise (a
    copy of ``scripts/train_vocabulary.py::render_patch_world``)."""
    img = np.full((480, 640), 90.0, np.float32)
    n_pat = rng.integers(120, 260)
    for _ in range(n_pat):
        y = rng.integers(6, 466)
        x = rng.integers(6, 626)
        s = rng.integers(5, 15)
        img[y:y + s, x:x + s] = rng.uniform(0, 255, (s, s))
    img += rng.normal(0, 2.5, img.shape)
    return img


def extractor_config():
    """The trainer's front end: 1000 features in 1024 slots, 8 levels."""
    from orb_slam_tpu_torch.config import ExtractorConfig
    return ExtractorConfig(n_features=1000, max_keypoints=1024, n_levels=8)


def extract_descs(img, ecfg=None, device=None) -> np.ndarray:
    """The valid descriptors [M, 8] int32 of one image from the port's
    per-level extractor on `device` (cuda unless the caller names the
    CPU)."""
    from orb_slam_tpu_torch.frontend.extractor import extract_default
    feats = extract_default(img, ecfg or extractor_config(), device=device)
    valid = feats.valid.cpu().numpy()
    return feats.desc.cpu().numpy()[valid]


def augment(corpus, doc, n_images, n_copies, rng):
    """Jittered copies of every descriptor (2-5 flipped bits each), each
    pass its own documents, as the JAX script's ``--augment``."""
    outs, outs_doc = [corpus], [doc]
    for a in range(n_copies):
        c = corpus.copy()
        flips = rng.integers(2, 6, size=len(c))
        bits = rng.integers(0, 256, size=(len(c), 5))
        for b in range(5):
            m = flips > b
            word = bits[m, b] // 32
            bit = bits[m, b] % 32
            rows = np.where(m)[0]
            c[rows, word] ^= (np.uint32(1) << bit.astype(np.uint32))
        outs.append(c)
        outs_doc.append(doc + (a + 1) * n_images)
    return np.concatenate(outs), np.concatenate(outs_doc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=80)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--augment", type=int, default=0,
                    help="extra jittered copies of each descriptor, each "
                         "its own document")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.abspath(SHIPPED):
        ap.error("--out names the shipped vocabulary; pick another path")

    from orb_slam_tpu_torch.place import vocabulary as voc_mod

    ecfg = extractor_config()
    rng = np.random.default_rng(0)
    descs, doc_ids = [], []
    t0 = time.time()
    for i in range(args.images):
        d = extract_descs(render_patch_world(rng), ecfg, args.device)
        descs.append(d)
        doc_ids.append(np.full(len(d), i))
        if (i + 1) % 10 == 0:
            print(f"  extracted {i + 1}/{args.images} images "
                  f"({sum(len(x) for x in descs)} descriptors, "
                  f"{time.time() - t0:.0f}s)", flush=True)
    corpus = np.concatenate(descs).view(np.uint32)
    doc = np.concatenate(doc_ids)
    if args.augment > 0:
        corpus, doc = augment(corpus, doc, args.images, args.augment, rng)
        print(f"augmented corpus: {len(corpus)} descriptors, "
              f"{int(doc.max()) + 1} documents", flush=True)
    print(f"training k={args.k} depth={args.depth} on {len(corpus)} "
          f"descriptors from {args.images} images ...", flush=True)
    t0 = time.time()
    voc = voc_mod.train(corpus, k=args.k, depth=args.depth, doc_ids=doc)
    print(f"trained {voc.n_words} words in {time.time() - t0:.0f}s")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    voc_mod.save_npz(voc, args.out)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
