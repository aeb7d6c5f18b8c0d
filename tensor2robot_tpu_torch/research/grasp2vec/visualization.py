"""Grasp2Vec heatmap visualization.

Counterpart of ``tensor2robot_tpu/research/grasp2vec/visualization.py``:
localize an object by correlating its outcome embedding with the scene's
spatial feature map.
"""

from __future__ import annotations

import numpy as np
import torch


def embedding_heatmap(scene_spatial: torch.Tensor,
                      query_embedding: torch.Tensor) -> torch.Tensor:
  """Spatial similarity map between a query embedding and scene features.

  Args:
    scene_spatial: (B, H, W, D) projected scene feature map (Grasp2Vec's
      outputs["scene_spatial"]).
    query_embedding: (B, D) embedding of the object to localize.

  Returns:
    (B, H, W) softmax-normalized heatmap.
  """
  logits = torch.einsum("bhwd,bd->bhw", scene_spatial.float(),
                        query_embedding.float())
  return torch.softmax(logits.flatten(1), dim=-1).reshape(logits.shape)


def heatmap_to_image(heatmap: np.ndarray) -> np.ndarray:
  """(H, W) heatmap -> uint8 grayscale image for metric writers."""
  heatmap = np.asarray(heatmap, np.float32)
  rng = heatmap.max() - heatmap.min()
  if rng <= 0:
    return np.zeros(heatmap.shape, np.uint8)
  norm = (heatmap - heatmap.min()) / rng
  return (norm * 255).astype(np.uint8)
