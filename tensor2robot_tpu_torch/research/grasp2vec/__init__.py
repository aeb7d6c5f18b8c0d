"""Grasp2Vec: self-supervised object embeddings (BASELINE #2)."""

from tensor2robot_tpu_torch.research.grasp2vec import losses, visualization
from tensor2robot_tpu_torch.research.grasp2vec.grasp2vec_model import (
    Grasp2VecModel,
)

__all__ = ["Grasp2VecModel", "losses", "visualization"]
