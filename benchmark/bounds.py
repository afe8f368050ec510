"""Least time of one LK level call on its inputs, by the bytes it needs.

Frozen copy of the bytes term of ``chip_smoke.py:322-350``
(``lk_level_bound``) with ``mqslam_tpu_torch/ops/lk_tile.py:59-61``'s
``search_side``: every input read once and every output written once; the
images count as the smaller of the regions the valid tracks touch (a
(win+3)^2 template grid and a P^2 search region each) and both level
images whole; per track its corners, anchors, flag and results.  It
counts what the call's inputs need, whatever kernel implements it.
"""

from benchmark import peaks

__all__ = ["search_side", "lk_level_bytes", "lk_level_seconds"]


def search_side(win, hiX):
    """Side P of the square search region: hiX = P - 2 - win."""
    return int(round(hiX)) + 2 + win


def lk_level_bytes(numel, px, tracks, n_valid, win, hiX):
    P = search_side(win, hiX)
    region = n_valid * ((win + 3) ** 2 + P * P) * px
    image = 2 * numel * px
    io = tracks * (2 * 8 + 2 * 8 + 1 + 8 + 4 + 4)
    return min(region, image) + io


def lk_level_seconds(numel, px, tracks, n_valid, win, hiX):
    return lk_level_bytes(numel, px, tracks, n_valid, win,
                          hiX) / peaks.HBM_BYTES_PER_S
