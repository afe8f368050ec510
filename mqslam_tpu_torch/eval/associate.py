"""Timestamp association between two trajectory files.

Semantics of the TUM benchmark tool (reference: Work/SLAM/tools/
tum_benchmark_tools/associate.py:49-91): potential pairs within
``max_difference`` are sorted by |dt| and greedily matched, each timestamp
used at most once.
"""

import numpy as np

__all__ = ["read_file_list", "associate", "associate_arrays"]


def read_file_list(filename):
    """Parse a TUM-style file into {timestamp: [values...]}
    (associate.py:49-68)."""
    out = {}
    with open(filename) as f:
        for line in f.read().replace(",", " ").replace("\t", " ").split("\n"):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.split()
            out[float(vals[0])] = [float(v) for v in vals[1:]]
    return out


def associate_arrays(t1, t2, offset=0.0, max_difference=0.02):
    """Greedy best-|dt| matching of two timestamp arrays.

    Returns list of (i, j) index pairs, sorted by t1 order.
    """
    t1 = np.asarray(t1, dtype=np.float64)
    t2 = np.asarray(t2, dtype=np.float64)
    pairs = []
    for i, a in enumerate(t1):
        dt = np.abs(a - (t2 + offset))
        js = np.where(dt < max_difference)[0]
        for j in js:
            pairs.append((dt[j], i, j))
    pairs.sort()
    used1, used2 = set(), set()
    matches = []
    for _, i, j in pairs:
        if i not in used1 and j not in used2:
            used1.add(i)
            used2.add(j)
            matches.append((i, j))
    matches.sort()
    return matches


def associate(first_list, second_list, offset=0.0, max_difference=0.02):
    """Dict-based association (associate.py:71-91 signature): returns list of
    (t1, t2) matched timestamp pairs."""
    k1 = sorted(first_list.keys())
    k2 = sorted(second_list.keys())
    matches = associate_arrays(k1, k2, offset, max_difference)
    return [(k1[i], k2[j]) for i, j in matches]
