"""Meta-learning: MAML as a model transformer, and meta-batched data."""

from tensor2robot_tpu_torch.meta_learning.maml_model import MAMLModel
from tensor2robot_tpu_torch.meta_learning.meta_data import (
    meta_batch_from_arrays,
    multi_batch_apply,
)

__all__ = ["MAMLModel", "meta_batch_from_arrays", "multi_batch_apply"]
