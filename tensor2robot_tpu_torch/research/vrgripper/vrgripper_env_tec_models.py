"""VRGripper task-embedded control (TEC) models.

Counterpart of
``tensor2robot_tpu/research/vrgripper/vrgripper_env_tec_models.py``. TEC
adapts with no gradient step at test time: an embedding network turns the
condition (demonstration) episodes into one task embedding, and the
control network is FiLM-conditioned on it.

The inputs are the task-batched condition/inference splits of
``meta_learning/maml_model.py``, so one meta batch feeds both families:
    condition/features/image         (B, N_c, H, W, 3)
    inference/features/image         (B, N_q, H, W, 3)
    inference/features/gripper_pose  (B, N_q, P)
    inference/labels/action          (B, N_q, A)   [TRAIN/EVAL only]

Loss = the query BC (MSE) + an n-pairs auxiliary over the task batch
(same-task condition and inference embeddings attract, other tasks
repel). The batch reshapes flatten and unflatten the leading axes, so an
exported program keeps the task count dynamic.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import modes
from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.layers.resnet import ResNet
from tensor2robot_tpu_torch.layers.vision_layers import Dense, ImagesToFeatures
from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    Metrics,
)
from tensor2robot_tpu_torch.research.grasp2vec.losses import npairs_loss
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models import (
    ACTION_SIZE,
    CONTEXT_SIZE,
    GRIPPER_POSE_SIZE,
    HIDDEN_SIZE,
    IMAGE_SIZE,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

_EMBEDDING_FILTERS = (16, 32, 32)


class _TaskEmbeddingModule(nn.Module):
  """Demo episodes -> one L2-normalized task embedding: (B*N, H, W, 3)
  images through a small conv tower, mean-pooled over space and samples,
  projected to `embedding_size`."""

  def __init__(self, embedding_size: int = 32,
               compute_dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.tower = ImagesToFeatures(filters=_EMBEDDING_FILTERS,
                                  strides=(2, 2, 2), dtype=compute_dtype)
    self.project = Dense(_EMBEDDING_FILTERS[-1], embedding_size,
                         torch.float32)

  def forward(self, images: torch.Tensor, num_samples: int,
              train: bool = False) -> torch.Tensor:
    feature_map = self.tower(images, train=train)
    pooled = torch.mean(feature_map, dim=(1, 2)).float()
    episode = pooled.unflatten(0, (-1, num_samples)).mean(dim=1)  # (B, F)
    emb = self.project(torch.relu(episode))
    return emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-8)


class _TECControlModule(nn.Module):
  """FiLM ResNet-18 conditioned on (task embedding, proprioception)."""

  def __init__(self, embedding_size: int, gripper_pose_size: int,
               action_size: int = ACTION_SIZE,
               compute_dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.compute_dtype = compute_dtype
    self.context_fc = Dense(gripper_pose_size, CONTEXT_SIZE, compute_dtype)
    self.tower = ResNet(depth=18, width=32, film=True, dtype=compute_dtype,
                        context_size=embedding_size + CONTEXT_SIZE)
    self.fc1 = Dense(
        self.tower.features + gripper_pose_size + embedding_size,
        HIDDEN_SIZE, torch.float32)
    self.action = Dense(HIDDEN_SIZE, action_size, torch.float32)

  def forward(self, images, gripper_pose, task_embedding,
              train: bool = False) -> torch.Tensor:
    dtype = self.compute_dtype
    proprio = torch.relu(self.context_fc(gripper_pose.to(dtype)))
    context = torch.cat([task_embedding.to(dtype), proprio], dim=-1)
    image_features = self.tower(images, context=context, train=train)
    x = torch.cat([image_features.float(), gripper_pose.float(),
                   task_embedding.float()], dim=-1)
    return self.action(torch.relu(self.fc1(x)))


class _TECModule(nn.Module):
  """Embedding + control wired over the meta batch layout."""

  def __init__(self, action_size: int, embedding_size: int,
               gripper_pose_size: int, compute_dtype: torch.dtype):
    super().__init__()
    self.embedding = _TaskEmbeddingModule(embedding_size, compute_dtype)
    self.control = _TECControlModule(embedding_size, gripper_pose_size,
                                     action_size, compute_dtype)

  def forward(self, features, mode: str):
    train = mode == modes.TRAIN
    cond_images = features["condition/features/image"]
    n_c = cond_images.shape[1]
    task_emb = self.embedding(cond_images.flatten(0, 1), num_samples=n_c,
                              train=train)  # (B, E)
    query_images = features["inference/features/image"]
    n_q = query_images.shape[1]
    emb_per_query = torch.repeat_interleave(task_emb, n_q, dim=0)
    actions = self.control(
        query_images.flatten(0, 1),
        features["inference/features/gripper_pose"].flatten(0, 1),
        emb_per_query, train=train)
    outputs = ts.TensorSpecStruct({
        "inference_output": actions.unflatten(0, (-1, n_q)),
        "task_embedding": task_emb,
    })
    if mode != modes.PREDICT:
      # The inference episodes' embedding for the contrastive loss, in
      # TRAIN and EVAL (eval measures what training optimizes).
      outputs["query_embedding"] = self.embedding(
          query_images.flatten(0, 1), num_samples=n_q, train=train)
    return outputs


@configurable
class VRGripperEnvTecModel(AbstractT2RModel):
  """Zero-shot-adaptation BC through task embeddings (TEC)."""

  def __init__(self, image_size: int = IMAGE_SIZE,
               action_size: int = ACTION_SIZE,
               gripper_pose_size: int = GRIPPER_POSE_SIZE,
               embedding_size: int = 32, num_condition_samples: int = 2,
               num_inference_samples: int = 2,
               embedding_loss_weight: float = 0.1, **kwargs):
    super().__init__(**kwargs)
    self._image_size = image_size
    self._action_size = action_size
    self._gripper_pose_size = gripper_pose_size
    self._embedding_size = embedding_size
    self.num_condition_samples = num_condition_samples
    self.num_inference_samples = num_inference_samples
    self._embedding_loss_weight = embedding_loss_weight

  def get_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    out = ts.TensorSpecStruct()
    # The condition episodes feed only the embedding net; the control net
    # takes the query images and proprioception. The query actions are a
    # TRAIN/EVAL input only: a serving request does not fabricate them.
    image = (self._image_size, self._image_size, 3)
    out["condition/features/image"] = ts.ExtendedTensorSpec(
        (self.num_condition_samples,) + image, np.float32)
    out["inference/features/image"] = ts.ExtendedTensorSpec(
        (self.num_inference_samples,) + image, np.float32)
    out["inference/features/gripper_pose"] = ts.ExtendedTensorSpec(
        (self.num_inference_samples, self._gripper_pose_size), np.float32)
    if mode != modes.PREDICT:
      out["inference/labels/action"] = ts.ExtendedTensorSpec(
          (self.num_inference_samples, self._action_size), np.float32)
    return out

  def get_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    del mode
    return ts.TensorSpecStruct()  # the query labels travel in the features

  def build_module(self) -> nn.Module:
    return _TECModule(self._action_size, self._embedding_size,
                      self._gripper_pose_size, self.compute_dtype)

  def loss_fn(self, outputs, features, labels
              ) -> Tuple[torch.Tensor, Metrics]:
    del labels
    target = features["inference/labels/action"].float()
    error = outputs["inference_output"].float() - target
    bc_loss = torch.mean(torch.square(error))
    metrics: Dict[str, torch.Tensor] = {
        "bc_mse": bc_loss,
        "mean_action_error": torch.mean(torch.linalg.norm(error, dim=-1)),
    }
    loss = bc_loss
    if "query_embedding" in outputs:
      # n-pairs over the task batch: a same-pair-only term would be
      # minimized by collapsing every task onto one embedding.
      embedding_loss, embedding_accuracy = npairs_loss(
          outputs["task_embedding"], outputs["query_embedding"])
      loss = loss + self._embedding_loss_weight * embedding_loss
      metrics["embedding_loss"] = embedding_loss
      metrics["embedding_accuracy"] = embedding_accuracy
      metrics["embedding_alignment"] = torch.mean(torch.sum(
          outputs["task_embedding"] * outputs["query_embedding"], dim=-1))
    metrics["loss"] = loss
    return loss, metrics
