"""PLY point-cloud export (ASCII or binary little-endian).

The reference recommends converting its PCD output with pcl's ``pcd2ply``
for other viewers (reference: Work/python_libs/dataset_tools.py:215-218,
blender_tools.py:398-421 extract_points_to_ply); this is that converter,
built in.
"""

import struct

import numpy as np

__all__ = ["save_ply", "pcd_to_ply"]


def save_ply(filename, points, colors=None, binary=True):
    """Write points [N, 3] (+ optional u8 colors [N, 3] as (B, G, R) like the
    PCD convention, stored to PLY as RGB) to a .ply file."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = len(points)
    has_c = colors is not None
    if has_c:
        colors = np.asarray(colors, dtype=np.uint8).reshape(n, -1)[:, :3]
        rgb = colors[:, ::-1]  # BGR -> RGB
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        + ("property uchar red\nproperty uchar green\nproperty uchar blue\n"
           if has_c else "")
        + "end_header\n")
    if binary:
        with open(filename, "wb") as f:
            f.write(header.encode())
            if has_c:
                for p, c in zip(points, rgb):
                    f.write(struct.pack("<fffBBB", *p, *c))
            else:
                f.write(points.astype("<f4").tobytes())
    else:
        with open(filename, "w") as f:
            f.write(header)
            for i in range(n):
                row = " ".join(f"{v:.6f}" for v in points[i])
                if has_c:
                    row += " " + " ".join(str(int(v)) for v in rgb[i])
                f.write(row + "\n")


def pcd_to_ply(pcd_file, ply_file, binary=True):
    """Convert one of our (or the reference's) PCD maps to PLY."""
    from mqslam_tpu_torch.io import pcd as pcd_mod
    pts, colors, _ = pcd_mod.load_pcd(pcd_file, use_alpha=False)
    save_ply(ply_file, pts, colors, binary=binary)
