"""Grasp2VecModel: phi(scene_pre) - phi(scene_post) ~= phi(outcome).

Counterpart of ``tensor2robot_tpu/research/grasp2vec/grasp2vec_model.py``
(BASELINE config #2): ResNet-50 feature towers over (scene_pre,
scene_post, outcome) images, one scene tower shared by pre and post and
one outcome tower, trained with the n-pairs loss on the embedding
arithmetic. In TRAIN the scene tower runs twice, pre then post, and its
BatchNorm averages move in that order, as flax moves them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import modes
from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.layers.resnet import ResNet
from tensor2robot_tpu_torch.layers.vision_layers import Dense
from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    Metrics,
)
from tensor2robot_tpu_torch.research.grasp2vec import losses, visualization
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

IMAGE_SIZE = 224
EMBEDDING_SIZE = 512


class _Grasp2VecModule(nn.Module):
  """Scene tower (shared by pre and post) + outcome tower -> embeddings."""

  def __init__(self, depth: int = 50, width: int = 64,
               embedding_size: int = EMBEDDING_SIZE, remat: bool = False,
               norm: str = "batch",
               compute_dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.scene_tower = ResNet(depth=depth, width=width, return_spatial=True,
                              remat=remat, norm=norm, dtype=compute_dtype)
    self.outcome_tower = ResNet(depth=depth, width=width, remat=remat,
                                norm=norm, dtype=compute_dtype)
    features = self.scene_tower.features
    self.scene_proj = Dense(features, embedding_size, torch.float32)
    self.outcome_proj = Dense(features, embedding_size, torch.float32)

  def forward(self, features, mode: str):
    train = mode == modes.TRAIN
    pre_features, pre_map = self.scene_tower(features["pre_image"],
                                             train=train)
    post_features, _ = self.scene_tower(features["post_image"], train=train)
    outcome_features = self.outcome_tower(features["goal_image"],
                                          train=train)
    pre_emb = self.scene_proj(pre_features.float())
    post_emb = self.scene_proj(post_features.float())
    return ts.TensorSpecStruct({
        "pre_embedding": pre_emb,
        "post_embedding": post_emb,
        "outcome_embedding": self.outcome_proj(outcome_features.float()),
        "inference_output": pre_emb - post_emb,
        # The pre-pool scene map, projected, (B, H, W, D): localization
        # heatmaps.
        "scene_spatial": self.scene_proj(pre_map.float()),
    })


@configurable
class Grasp2VecModel(AbstractT2RModel):
  """Self-supervised object-embedding model (no labels)."""

  def __init__(self, image_size: int = IMAGE_SIZE, depth: int = 50,
               width: int = 64, embedding_size: int = EMBEDDING_SIZE,
               l2_reg: float = 2e-3, remat: bool = False,
               norm: str = "batch", **kwargs):
    """remat: rematerialize the residual blocks in the backward pass
    (``layers.resnet.ResNet``): three ResNet-50 towers at 224x224 are the
    framework's most activation-hungry workload.

    norm: 'batch' (the reference) or 'group'. The model's signal
    phi(pre) - phi(post) is a small difference of large embeddings. In
    TRAIN each BatchNorm call normalizes with its own batch's statistics,
    coupling every embedding to its batchmates; the running averages
    cannot reproduce that coupling at eval, and the difference drowns.
    GroupNorm is batch-independent and is the setting for training this
    model from scratch (the JAX package's note)."""
    super().__init__(**kwargs)
    self._image_size = image_size
    self._depth = depth
    self._width = width
    self._embedding_size = embedding_size
    self._l2_reg = l2_reg
    self._remat = remat
    self._norm = norm

  def get_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    image = lambda name: ts.ExtendedTensorSpec(  # noqa: E731
        (self._image_size, self._image_size, 3), np.float32, name=name)
    return ts.TensorSpecStruct({
        "pre_image": image("pre_image"),
        "post_image": image("post_image"),
        "goal_image": image("goal_image"),
    })

  def build_module(self) -> nn.Module:
    return _Grasp2VecModule(
        depth=self._depth, width=self._width,
        embedding_size=self._embedding_size, remat=self._remat,
        norm=self._norm, compute_dtype=self.compute_dtype)

  def loss_fn(self, outputs, features, labels
              ) -> Tuple[torch.Tensor, Metrics]:
    del features, labels  # self-supervised
    loss, accuracy = losses.npairs_loss(
        outputs["inference_output"], outputs["outcome_embedding"],
        l2_reg=self._l2_reg)
    return loss, {"npairs": loss, "retrieval_accuracy": accuracy}

  def model_image_summaries_fn(self, variables, features):
    """The localization heatmap of the first eval example: where in the
    pre-grasp scene the outcome object's embedding correlates."""
    device = next(iter(variables.values())).device
    first = ts.TensorSpecStruct(
        (key, torch.as_tensor(value[:1]).to(device))
        for key, value in ts.flatten_spec_structure(features).items())
    with torch.no_grad():
      outputs, _ = self.inference_network_fn(variables, first, modes.EVAL)
    heat = visualization.embedding_heatmap(outputs["scene_spatial"],
                                           outputs["outcome_embedding"])
    return {
        "grasp2vec_heatmap": visualization.heatmap_to_image(
            heat[0].cpu().numpy()),
        "grasp2vec_pre_image": first["pre_image"][0].float().cpu().numpy(),
    }
