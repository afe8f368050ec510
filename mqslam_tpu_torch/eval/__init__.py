"""Trajectory evaluation: association, ATE, RPE, sim(3)-style alignment.

``associate``, ``ate`` and ``rpe`` are NumPy float64 on the host, copies of
the JAX package's modules (the TUM tools' semantics, RPE's biased binary
search included); ``alignment`` runs its quaternion algebra in float32
tensors, as the JAX package does without 64-bit mode.
"""

from mqslam_tpu_torch.eval import alignment, associate, ate, rpe  # noqa: F401
