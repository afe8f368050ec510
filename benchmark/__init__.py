"""The benchmark of the PyTorch/CUDA port (``mqslam_tpu_torch``).

See ``harness.py``; run a cell with ``python3 benchmark/run.py``.
"""
