"""One run of one benchmark cell; prints the result's JSON line last.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

(also ``python3 -m benchmark.run ...``) from the root of a checkout that
holds ``BENCHMARK.json``, ``benchmark/`` and ``mqslam_tpu_torch/``.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = _root
elif _root not in sys.path:
    sys.path.insert(0, _root)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_process=T_PROCESS))
