"""mgm_tpu_torch: the PyTorch / CUDA port of mgm_tpu.

The MGM (More Global Matching) stereo pipeline on one NVIDIA Hopper GPU:
plain PyTorch tensor code around hand-written CUDA kernels
(mgm_tpu_torch/csrc), which are built with nvcc at first use.  On CPU
tensors every kernel runs its plain PyTorch version instead.  This
package never imports jax or mgm_tpu; mgm_tpu stays the reference it is
tested against.
"""
from .config import MGMConfig
from .stereo import compute_disparity

__all__ = ["MGMConfig", "compute_disparity"]
