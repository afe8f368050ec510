"""Distinguishable color palette (Lab grid) + per-pixel color sampling.

Semantics of the reference's color tooling (reference:
Work/python_libs/color_tools.py:8-36 color_palette — a Lab-space grid over
the human-distinguishable box L:[99,230] a:[26,230] b:[26,230], converted to
RGB, shuffled with seed 1 — and :39-43 sample_colors, nearest-pixel lookup).
The Lab->RGB conversion is implemented here directly (OpenCV 8-bit Lab
convention: L*255/100, a/b offset by 128, D65, sRGB gamma) so no cv2
dependency; point-group coloring in the tracker consumes the palette by
group id modulo the palette size, as slam2.py:624-631 does.
"""

import numpy as np

__all__ = ["color_palette", "sample_colors", "lab8_to_rgb8"]


def lab8_to_rgb8(lab):
    """OpenCV-convention 8-bit Lab -> 8-bit RGB (D65, sRGB companding).

    lab [..., 3] uint8/float with L in [0,255] (=L* * 255/100), a/b offset
    by 128. Returns uint8 RGB.
    """
    lab = np.asarray(lab, np.float64)
    L = lab[..., 0] * (100.0 / 255.0)
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0

    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def f_inv(t):
        t3 = t ** 3
        return np.where(t3 > 0.008856, t3, (t - 16.0 / 116.0) / 7.787)

    # D65 white point
    X = 0.950456 * f_inv(fx)
    Y = f_inv(fy)
    Z = 1.088754 * f_inv(fz)

    r = 3.240479 * X - 1.53715 * Y - 0.498535 * Z
    g = -0.969256 * X + 1.875991 * Y + 0.041556 * Z
    bl = 0.055648 * X - 0.204043 * Y + 1.057311 * Z
    rgb = np.stack([r, g, bl], axis=-1)
    rgb = np.clip(rgb, 0.0, 1.0)
    rgb = np.where(rgb > 0.0031308,
                   1.055 * np.power(rgb, 1.0 / 2.4) - 0.055,
                   12.92 * rgb)
    return np.clip(np.rint(rgb * 255.0), 0, 255).astype(np.uint8)


def color_palette(nc_L, nc_a, nc_b):
    """Grid of nc_L*nc_a*nc_b distinguishable RGB colors, seeded shuffle.

    Returns (palette [num, 3] uint8 RGB, num). Matches the reference's grid
    limits, ordering, and seed-1 permutation (color_tools.py:16-34); colors
    differ only through the Lab->RGB conversion (ours is float-exact sRGB,
    OpenCV's is fixed-point) by at most a quantization step.
    """
    L_min, L_max = 99, 230
    a_min, a_max = 26, 230
    b_min, b_max = 26, 230
    num = nc_L * nc_a * nc_b
    lab = np.zeros((num, 3), np.float64)
    Ls = np.arange(L_min, L_max + 1, (L_max - L_min) / (nc_L - 1))
    As = np.arange(a_min, a_max + 1, (a_max - a_min) / (nc_a - 1))
    Bs = np.arange(b_min, b_max + 1, (b_max - b_min) / (nc_b - 1))
    for Li in range(nc_L):
        for ai in range(nc_a):
            for bi in range(nc_b):
                lab[Li * nc_a * nc_b + ai * nc_b + bi] = (
                    Ls[Li], As[ai], Bs[bi])
    # plain uint8 cast truncates, matching the reference's assignment of the
    # float grid values into a uint8 Lab image (color_tools.py:24-28)
    palette = lab8_to_rgb8(lab.astype(np.uint8))
    rstate = np.random.get_state()
    np.random.seed(1)
    palette = np.random.permutation(palette)
    np.random.set_state(rstate)
    return palette, num


def sample_colors(img, imgp):
    """Colors of image ``img`` at pixel points ``imgp`` [N, 2] (x, y) by
    nearest-pixel lookup (color_tools.py:39-43)."""
    imgp = np.asarray(imgp)
    idx = np.rint(imgp[:, ::-1]).astype(int)
    idx[:, 0] = np.clip(idx[:, 0], 0, img.shape[0] - 1)
    idx[:, 1] = np.clip(idx[:, 1], 0, img.shape[1] - 1)
    return img[tuple(idx.T)]
