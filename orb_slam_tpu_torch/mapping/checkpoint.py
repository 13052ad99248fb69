"""Map checkpoint and resume (port of ``orb_slam_tpu.mapping.checkpoint``):
save and load the whole SoA map state as one ``.npz``.

The reference has no map persistence (SURVEY.md §5.4: only the final
trajectory dump).  The file is the JAX package's, key for key and dtype
for dtype, so a map saved by either package loads in the other: the
counters (``n_kf``, ``n_mp``), the spanning tree (``parent``), the loop
edges, ``kf_frame_id``, ``kf_timestamp`` and ``state_<field>`` for every
MapState field, with the descriptors as uint32 (the port keeps them as
int32 views of the same bits).  The compaction LUTs and counters are not
saved.
"""
from __future__ import annotations

import numpy as np

from ..config import MapConfig
from .mapstore import _HOST, MapState, SlamMap


def save_map(path: str, smap: SlamMap) -> None:
    """Write the map's tables (read back from its device) and host
    counters to `path`."""
    arrays = {}
    for k, v in smap.state._asdict().items():
        a = v.detach().cpu().numpy()
        arrays[f"state_{k}"] = a.view(np.uint32) if k.endswith("desc") else a
    np.savez_compressed(
        path,
        n_kf=smap.n_kf,
        n_mp=smap.n_mp,
        parent=smap.parent,
        loop_edges=np.asarray(smap.loop_edges or [], np.int64).reshape(-1, 2),
        kf_frame_id=smap.kf_frame_id,
        kf_timestamp=smap.kf_timestamp,
        **arrays,
    )


def load_map(path: str, cfg: MapConfig, device=None) -> SlamMap:
    """The saved map on `device` (the card unless the caller names
    another), with its host mirrors rebuilt from the arrays.  The keyframe
    pool may have grown past `cfg.max_keyframes` before the save: the
    arrays decide the capacity (``SlamMap.from_numpy``)."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[f"state_{k}"] for k in MapState._fields}
        counters = dict(
            cfg=cfg, n_kf=int(data["n_kf"]), n_mp=int(data["n_mp"]),
            parent=data["parent"],
            loop_edges=[tuple(e) for e in data["loop_edges"]],
            kf_frame_id=data["kf_frame_id"],
            kf_timestamp=data["kf_timestamp"],
            obs_np=arrays["kf_obs"], kf_valid_np=arrays["kf_valid"],
            mp_valid_np=arrays["mp_valid"])
    host = {n: arrays[n] for n in _HOST}
    return SlamMap.from_numpy(arrays, host, counters, device=device)
