"""Hand-written CUDA kernels, each beside its plain PyTorch version."""

from tensor2robot_tpu_torch.ops.spatial_softmax import (
    spatial_softmax,
    spatial_softmax_reference,
)

__all__ = ["spatial_softmax", "spatial_softmax_reference"]
