"""Host graph ops of the map (port of ``orb_slam_tpu.native``).

``pack_ba_edges``, ``remap_observations``, ``covisibility_counts`` and
``vote_keyframes`` run in the compiled extension built from the port's own
copy of the JAX package's source (``csrc/graphops.cpp``, byte-equal, held
so by ``tests/test_torch_native.py``) into ``_build/`` by ``g++`` at first
use.  Each function has a numpy version (``*_plain``), the JAX package's
fallback.

Which one runs is explicit: ``backend()`` says "compiled" or "numpy", and
``require_compiled()`` raises with the compiler's output when the build
failed.  The tracker calls it when it runs on the card, so a failed build
never quietly turns into the numpy path there.
"""
from __future__ import annotations

import importlib.util
import threading

import numpy as np

from .. import _build

_lock = threading.Lock()
_mod = None
_error: str | None = None
_tried = False


def _load():
    """The compiled module, built on first call (None if the build
    failed; the error is kept for require_compiled)."""
    global _mod, _error, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                path = _build.build_host_extension("graphops")
                spec = importlib.util.spec_from_file_location(
                    "orb_slam_tpu_torch.native._graphops", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _mod = mod
            except Exception as e:   # kept and re-raised by require_compiled
                _error = f"{type(e).__name__}: {e}"
        return _mod


def backend() -> str:
    """"compiled" when the g++ build loaded, else "numpy"."""
    return "compiled" if _load() is not None else "numpy"


def require_compiled() -> None:
    """Raise unless the compiled extension is the one in use."""
    if _load() is None:
        raise RuntimeError(f"graphops extension unavailable: {_error}")


# ---------------------------------------------------------------------------
# numpy versions (the JAX package's fallbacks, native/__init__.py:63-135)
# ---------------------------------------------------------------------------

def pack_ba_edges_plain(obs, kp_valid, lut):
    obs = np.ascontiguousarray(obs, np.int32)
    kpv = np.ascontiguousarray(kp_valid, np.uint8)
    lut = np.ascontiguousarray(lut, np.int32)
    C, N = obs.shape
    cam_idx = np.repeat(np.arange(C, dtype=np.int32), N)
    slot_idx = np.tile(np.arange(N, dtype=np.int32), C)
    pid = obs.reshape(-1)
    local = np.where((pid >= 0) & (pid < len(lut)),
                     lut[np.clip(pid, 0, len(lut) - 1)], -1)
    valid = (local >= 0) & kpv.reshape(-1).astype(bool)
    return cam_idx, np.where(valid, local, 0).astype(np.int32), slot_idx, valid


def remap_observations_plain(obs: np.ndarray, lut: np.ndarray) -> int:
    assert (obs.dtype == np.int32 and obs.flags.c_contiguous
            and obs.flags.writeable)
    lut = np.ascontiguousarray(lut, np.int32)
    changed = 0
    P1 = len(lut)
    for k in range(obs.shape[0]):
        row = obs[k]
        pid = row.copy()
        m = (pid >= 0) & (pid < P1)
        row[m] = lut[pid[m]]
        changed += int((row != pid).sum())
        seen = {}
        for n in np.where(row >= 0)[0]:
            v = int(row[n])
            if v in seen:
                row[n] = -1
                changed += 1
            else:
                seen[v] = n
    return changed


def covisibility_counts_plain(obs, kf_valid, n_points: int) -> np.ndarray:
    obs = np.ascontiguousarray(obs, np.int32)
    kfv = np.ascontiguousarray(kf_valid, np.uint8)
    K = obs.shape[0]
    ks, ns = np.nonzero((obs >= 0) & (obs < n_points)
                        & kfv.astype(bool)[:, None])
    pid = obs[ks, ns]
    order = np.argsort(pid, kind="stable")
    pid, ks = pid[order], ks[order]
    W = np.zeros((K, K), np.int32)
    starts = np.flatnonzero(np.concatenate(
        [[True], pid[1:] != pid[:-1], [True]]))
    for a, b in zip(starts[:-1], starts[1:]):
        grp = ks[a:b]
        if len(grp) > 1:
            np.add.at(W, (grp[:, None], grp[None, :]), 1)
    np.fill_diagonal(W, 0)
    return W


def vote_keyframes_plain(obs, seed) -> np.ndarray:
    obs = np.ascontiguousarray(obs, np.int32)
    seed = np.asarray(seed)
    hits = seed.astype(bool)[np.clip(obs, 0, len(seed) - 1)] & (obs >= 0)
    return hits.sum(axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# the entry points: the compiled extension when it is built
# ---------------------------------------------------------------------------

def pack_ba_edges(obs: np.ndarray, kp_valid: np.ndarray, lut: np.ndarray):
    """obs [C,N] int32, kp_valid [C,N] bool, lut [P+1] int32 (global point
    id -> local index, -1 absent) -> (cam_idx, pt_idx, slot_idx, valid)."""
    mod = _load()
    if mod is None:
        return pack_ba_edges_plain(obs, kp_valid, lut)
    obs = np.ascontiguousarray(obs, np.int32)
    kpv = np.ascontiguousarray(kp_valid, np.uint8)
    lut = np.ascontiguousarray(lut, np.int32)
    cam_b, pt_b, slot_b, val_b = mod.pack_ba_edges(obs, kpv, lut)
    n = obs.size
    return (np.frombuffer(bytes(cam_b), np.int32, n),
            np.frombuffer(bytes(pt_b), np.int32, n),
            np.frombuffer(bytes(slot_b), np.int32, n),
            np.frombuffer(bytes(val_b), np.uint8, n).astype(bool))


def remap_observations(obs: np.ndarray, lut: np.ndarray) -> int:
    """In-place landmark-merge remap of obs [K,N] via lut [P+1]; removes
    duplicate landmark ids within each keyframe row.  Returns #changes."""
    mod = _load()
    if mod is None:
        return remap_observations_plain(obs, lut)
    assert (obs.dtype == np.int32 and obs.flags.c_contiguous
            and obs.flags.writeable)
    return int(mod.remap_observations(obs, np.ascontiguousarray(lut,
                                                                np.int32)))


def covisibility_counts(obs: np.ndarray, kf_valid: np.ndarray,
                        n_points: int) -> np.ndarray:
    """obs [K,N] int32, kf_valid [K] bool -> [K,K] int32 shared-observation
    counts (diagonal zero)."""
    mod = _load()
    if mod is None:
        return covisibility_counts_plain(obs, kf_valid, n_points)
    obs = np.ascontiguousarray(obs, np.int32)
    kfv = np.ascontiguousarray(kf_valid, np.uint8)
    K = obs.shape[0]
    out = mod.covisibility_counts(obs, kfv, int(n_points))
    return np.frombuffer(bytes(out), np.int32, K * K).reshape(K, K).copy()


def vote_keyframes(obs: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """obs [K,N] int32, seed [P+1] bool -> votes [K] int32."""
    mod = _load()
    if mod is None:
        return vote_keyframes_plain(obs, seed)
    obs = np.ascontiguousarray(obs, np.int32)
    out = mod.vote_keyframes(obs, np.ascontiguousarray(seed, np.uint8))
    return np.frombuffer(bytes(out), np.int32, obs.shape[0])
