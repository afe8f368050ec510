"""ASCII PCD point-cloud IO with the packed-float BGRA color convention.

Wire-compatible with the reference (reference: Work/python_libs/
dataset_tools.py:118-267): colors ride in a float32 whose 4 bytes are
(B, G, R, A); on save, the two least-significant bits of alpha are forced to
0b01 so the float's exponent byte can never be 0x00 (denormal) or 0xFF
(NaN/Inf) — dataset_tools.py:249-258.
"""

import struct

import numpy as np

__all__ = ["load_pcd", "save_pcd"]


def load_pcd(filename, use_alpha: bool = False):
    """Load an ASCII PCD file -> (points [N,3] f32, colors [N,3|4] u8 | None,
    found_alpha).

    Supports the reference's header subset: FIELDS x y z [rgb], HEIGHT 1,
    DATA ascii (dataset_tools.py:130-139).
    """
    with open(filename) as f:
        lines = f.read().split("\n")

    num_points = 0
    use_colors = False
    data_start = None
    expect = "FIELDS"
    for i, line in enumerate(lines):
        words = line.split(" ")
        if words[0] == expect == "FIELDS":
            if words[1:4] != ["x", "y", "z"]:
                raise ValueError(f"Unsupported PCD FIELDS: {words[1:]}")
            if len(words) == 5 and words[4] == "rgb":
                use_colors = True
            elif len(words) != 4:
                raise ValueError(f"Unsupported PCD FIELDS: {words[1:]}")
            expect = "WIDTH"
        elif words[0] == expect == "WIDTH":
            num_points = int(words[1])
            expect = "HEIGHT"
        elif words[0] == expect == "HEIGHT":
            if int(words[1]) != 1:
                raise ValueError("Organized PCD clouds are not supported.")
            expect = "DATA"
        elif words[0] == expect == "DATA":
            if words[1] != "ascii":
                raise ValueError(f"Unsupported PCD DATA: {words[1]!r}")
            data_start = i + 1
            break
    if data_start is None:
        raise ValueError("PCD header incomplete.")

    data = lines[data_start:data_start + num_points]
    if len(data) < num_points:
        raise ValueError(f"PCD advertises {num_points} points, found "
                         f"{len(data)}.")
    vals = np.array([[float(v) for v in line.split()] for line in data],
                    dtype=np.float32)
    if not len(vals):
        return np.zeros((0, 3), dtype=np.float32), None, False

    found_alpha = False
    colors = None
    if use_colors:
        packed = np.ascontiguousarray(vals[:, 3], dtype=np.float32)
        colors = packed.view(np.uint8).reshape(-1, 4)  # little-endian B,G,R,A
        found_alpha = True
        if not use_alpha:
            colors = colors[:, :3]
        vals = vals[:, :3]
    return np.ascontiguousarray(vals[:, :3]), colors, found_alpha


def save_pcd(filename, points, colors=None):
    """Save points [N,3] (+ optional u8 colors [N,3|4] as (B,G,R[,A])) to an
    ASCII PCD file, byte-compatible with dataset_tools.py:206-267."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    has_colors = colors is not None
    header = (
        "# .PCD v.7 - Point Cloud Data file format\n"
        "VERSION .7\n"
        f"FIELDS x y z{' rgb' * has_colors}\n"
        f"SIZE 4 4 4{' 4' * has_colors}\n"
        f"TYPE F F F{' F' * has_colors}\n"
        f"COUNT 1 1 1{' 1' * has_colors}\n"
        f"WIDTH {len(points)}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {len(points)}\n"
        "DATA ascii\n"
    )
    cols = points
    if has_colors:
        colors = np.asarray(colors, dtype=np.uint8)
        if colors.shape[1] == 4:
            alpha = (colors[:, 3] & 0b11111100) | 0b01
        else:
            alpha = np.full(len(colors), 0xFD, dtype=np.uint8)
        bgra = np.column_stack([colors[:, :3], alpha]).astype(np.uint8)
        packed = np.ascontiguousarray(bgra).view(np.float32).reshape(-1, 1)
        cols = np.concatenate([points, packed], axis=1)
    body = "\n".join(" ".join("%.8e" % v for v in row) for row in cols)
    with open(filename, "w") as f:
        f.write(header + body + "\n")


def _float_to_bgra(f):
    """One packed float -> (B, G, R, A) bytes (debug helper)."""
    return tuple(struct.pack("<f", float(f)))
