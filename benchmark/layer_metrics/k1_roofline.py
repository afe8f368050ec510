"""K1 (``csrc/lk_level.cu``, the fleet's tile kernel): the bytes bound of
each call over its device time by kernel name, in percent."""

from benchmark.layer_metrics import _lk


def read(trace):
    return _lk.roofline(trace, "K1", "lk_level_")
