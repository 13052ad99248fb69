"""Map and frame export for inspection (port of ``orb_slam_tpu.utils.viz``).

Replaces the reference's rviz publishers (FramePublisher/MapPublisher,
src/FramePublisher.cc, src/MapPublisher.cc): instead of live ROS markers,
the sparse map, keyframe centres, spanning tree, loop edges and trajectory
go to a PNG (matplotlib, headless, imported when called), or the map
points to a PLY point cloud (no dependency).  Tensors are read through
``.cpu().numpy()``.
"""
from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def _map_points(smap) -> np.ndarray:
    st = smap.state
    return _np(st.mp_pos)[_np(st.mp_valid)]


def export_map_png(path: str, smap, trajectory=None, max_points: int = 20000):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = _map_points(smap)[:max_points]
    fig, ax = plt.subplots(figsize=(9, 9))
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1.5, c="#777777", label="map points")

    # keyframe centres and the spanning tree (MapPublisher draws frusta and
    # the tree, src/MapPublisher.cc:29-117)
    n = smap.n_kf
    kf_R, kf_t = _np(smap.state.kf_R)[:n], _np(smap.state.kf_t)[:n]
    centers = -np.einsum("kji,kj->ki", kf_R, kf_t)       # -R^T t per keyframe
    if len(centers):
        ax.plot(centers[:, 0], centers[:, 2], "b.-", ms=4, lw=0.8,
                label="keyframes")
        for k in range(n):
            p = int(smap.parent[k])
            if p >= 0:
                ax.plot([centers[k, 0], centers[p, 0]],
                        [centers[k, 2], centers[p, 2]], "g-", lw=0.5)
        for a, b in (smap.loop_edges or []):
            ax.plot([centers[a, 0], centers[b, 0]],
                    [centers[a, 2], centers[b, 2]], "r-", lw=1.5,
                    label="loop edge")

    if trajectory is not None and len(trajectory):
        tr = np.asarray([
            -np.asarray(rec.R).T @ np.asarray(rec.t)
            for rec in trajectory if rec.tracked])
        if len(tr):
            ax.plot(tr[:, 0], tr[:, 2], "k-", lw=0.5, alpha=0.6,
                    label="trajectory")

    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def export_frame_png(path: str, image, feats, assoc_valid=None, status: str = ""):
    """Debug frame image (FramePublisher's role, src/FramePublisher.cc:
    59-188): keypoints over the frame, green boxes for tracked landmarks,
    blue dots for unmatched detections, and a status line."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = _np(image)
    xy = _np(feats.xy)
    valid = _np(feats.valid)
    tracked = (_np(assoc_valid) if assoc_valid is not None
               else np.zeros(len(xy), bool))

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    free = valid & ~tracked
    ax.plot(xy[free, 0], xy[free, 1], ".", color="#4488ff", ms=2)
    trk = valid & tracked
    ax.plot(xy[trk, 0], xy[trk, 1], "s", mfc="none", mec="#00cc44", ms=5,
            mew=0.8)
    ax.set_title(f"{status}  kp={int(valid.sum())} tracked={int(trk.sum())}",
                 fontsize=9)
    ax.set_axis_off()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def export_map_ply(path: str, smap):
    pts = _map_points(smap)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
