"""Dataset adapters: ICL-NUIM and SVO synthetic sequences."""

from mqslam_tpu_torch.datasets import icl_nuim, svo  # noqa: F401
