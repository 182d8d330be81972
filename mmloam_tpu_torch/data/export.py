"""Point-cloud / trajectory export (port of mmloam_tpu/data/export.py):
ASCII PCD for clouds and TUM-format trajectories (timestamp tx ty tz qx qy
qz qw).  `save_pcd`, `save_trajectory_tum` and `load_trajectory_tum` are
numpy copies of the reference's; `save_map_pcd` reads the map through the
port's `voxelmap.cell_centroids`.
"""

from __future__ import annotations

import numpy as np


def save_pcd(path, pts, intensity=None):
    """Write an ASCII PCD v0.7 file (x y z [intensity])."""
    pts = np.asarray(pts, np.float32)
    n = len(pts)
    fields = "x y z" + (" intensity" if intensity is not None else "")
    ftypes = "F F F" + (" F" if intensity is not None else "")
    fsizes = "4 4 4" + (" 4" if intensity is not None else "")
    fcount = "1 1 1" + (" 1" if intensity is not None else "")
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n")
        f.write("VERSION 0.7\n")
        f.write(f"FIELDS {fields}\n")
        f.write(f"SIZE {fsizes}\nTYPE {ftypes}\nCOUNT {fcount}\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {n}\nDATA ascii\n")
        for i in range(n):
            row = f"{pts[i, 0]:.6f} {pts[i, 1]:.6f} {pts[i, 2]:.6f}"
            if intensity is not None:
                row += f" {float(intensity[i]):.3f}"
            f.write(row + "\n")


def save_map_pcd(path, vm, map_cfg):
    """Export a voxel map's valid cell centroids as PCD; returns how many
    were written."""
    from ..ops import voxelmap

    cents, valid = voxelmap.cell_centroids(vm, map_cfg)
    cents = cents[valid].detach().cpu().numpy()
    save_pcd(path, cents)
    return len(cents)


def save_trajectory_tum(path, ts, pos, quat_wxyz):
    """TUM trajectory format: `t x y z qx qy qz qw` per line."""
    ts = np.asarray(ts)
    pos = np.asarray(pos)
    q = np.asarray(quat_wxyz)
    with open(path, "w") as f:
        for i in range(len(ts)):
            f.write(f"{float(ts[i]):.6f} "
                    f"{pos[i, 0]:.6f} {pos[i, 1]:.6f} {pos[i, 2]:.6f} "
                    f"{q[i, 1]:.7f} {q[i, 2]:.7f} {q[i, 3]:.7f} "
                    f"{q[i, 0]:.7f}\n")


def load_trajectory_tum(path):
    """Inverse of save_trajectory_tum -> (ts, pos (N,3), quat_wxyz (N,4))."""
    data = np.loadtxt(path).reshape(-1, 8)
    ts = data[:, 0]
    pos = data[:, 1:4]
    q = np.concatenate([data[:, 7:8], data[:, 4:7]], axis=1)
    return ts, pos, q
