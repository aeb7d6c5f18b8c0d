"""Pose-env MAML: the meta-learned variant of the pose regressor.

Counterpart of ``tensor2robot_tpu/research/pose_env/pose_env_maml_models.py``:
``PoseEnvRegressionModel`` (the 32/48/64 conv tower, the spatial softmax
kernel, the pose head) wrapped in ``MAMLModel``, so each task adapts from
a handful of condition episodes before it predicts its query poses. The
factory defaults the base to float32 (MAML's inner gradients are unstable
in bfloat16) and to GroupNorm (the inner loop never collects BatchNorm
statistics, so a BatchNorm base would serve with its initial ones).

As in the JAX factory, `base_kwargs` (``optimizer_fn`` among them) go to
the base model, and the MAML model trains with its own default optimizer,
Adam 1e-4: the JAX check's bar was measured so (``ROADMAP.md`` Facts).
"""

from __future__ import annotations

import torch

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.meta_learning import MAMLModel
from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
    PoseEnvRegressionModel,
)


def _pose_env_maml_model(
    num_inner_steps: int = 1,
    inner_lr: float = 0.01,
    learn_inner_lr: bool = False,
    first_order: bool = False,
    num_condition_samples: int = 4,
    num_inference_samples: int = 4,
    **base_kwargs,
) -> MAMLModel:
  """Builds the meta-learned pose regressor; `base_kwargs` go to
  ``PoseEnvRegressionModel`` (image_size, optimizer_fn, norm, ...)."""
  base_kwargs.setdefault("compute_dtype", torch.float32)
  base_kwargs.setdefault("norm", "group")
  return MAMLModel(
      PoseEnvRegressionModel(**base_kwargs),
      num_inner_steps=num_inner_steps,
      inner_lr=inner_lr,
      learn_inner_lr=learn_inner_lr,
      first_order=first_order,
      num_condition_samples=num_condition_samples,
      num_inference_samples=num_inference_samples)


# Both names are configurables, so config files may use either
# `@pose_env_maml_model()` or the reference's `@PoseEnvRegressionModelMAML()`.
pose_env_maml_model = configurable(_pose_env_maml_model,
                                   name="pose_env_maml_model")
PoseEnvRegressionModelMAML = configurable(
    _pose_env_maml_model, name="PoseEnvRegressionModelMAML")
