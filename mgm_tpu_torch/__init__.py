"""mgm_tpu_torch: the PyTorch / CUDA port of mgm_tpu.

The MGM (More Global Matching) stereo pipeline on NVIDIA Hopper GPUs:
plain PyTorch tensor code around hand-written CUDA kernels
(mgm_tpu_torch/csrc), which are built with nvcc at first use.  On CPU
tensors every kernel runs its plain PyTorch version instead.  Row
sharding over several ranks lives in `mgm_tpu_torch.parallel`.  This
package never imports jax or mgm_tpu; mgm_tpu stays the reference it is
tested against.
"""
from .config import MGMConfig
from .stereo import compute_disparity, compute_disparity_batch
from .mrf import solve_mrf
from .runner import tiled_disparity

__version__ = "0.3.0"
__all__ = ["MGMConfig", "compute_disparity", "compute_disparity_batch",
           "solve_mrf", "tiled_disparity"]
