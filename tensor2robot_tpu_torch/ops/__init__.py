"""Hand-written CUDA kernels, each beside its plain PyTorch version."""

from tensor2robot_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from tensor2robot_tpu_torch.ops.spatial_softmax import (
    spatial_softmax,
    spatial_softmax_reference,
)

__all__ = ["flash_attention", "flash_attention_reference", "spatial_softmax",
           "spatial_softmax_reference"]
