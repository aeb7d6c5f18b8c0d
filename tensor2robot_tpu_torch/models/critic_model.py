"""CriticModel: (state, action) -> scalar Q-value base class.

Counterpart of ``tensor2robot_tpu/models/critic_model.py``, the base of the
QT-Opt grasping Q-function. Bellman targets arrive as labels; the model
itself is a supervised critic. ``cross_entropy`` treats the target as a
probability of success against a sigmoid Q head (the grasping
formulation); ``mse`` is the generic regression critic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.nn.utils import stateless

from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    Metrics,
)


class CriticModel(AbstractT2RModel):
  """Q(s, a) critic. The module's outputs hold ``q_predicted``: the
  pre-sigmoid logit for loss_type='cross_entropy', the raw value for
  'mse'.

  Args:
    target_key: the label key of the Bellman (or success) target.
    loss_type: 'cross_entropy' (QT-Opt grasping) or 'mse'.
  """

  def __init__(self, target_key: str = "target_q",
               loss_type: str = "cross_entropy", **kwargs):
    if loss_type not in ("cross_entropy", "mse"):
      raise ValueError(f"Unknown loss_type {loss_type!r}")
    super().__init__(**kwargs)
    self.target_key = target_key
    self.loss_type = loss_type

  def q_value(self, outputs) -> torch.Tensor:
    """Q in value space (a float32 sigmoid for the cross-entropy head)."""
    q = outputs["q_predicted"]
    if self.loss_type == "cross_entropy":
      return torch.sigmoid(q.float())
    return q

  def factored_cem_fns(self):
    """(encode_fn, q_from_code_fn) when the module splits its
    action-independent prefix (``encode(features) -> code``,
    ``q_from_code({"image": code, "action": actions})``), else None.

    Both take (variables, features), as ``predict_fn`` does: a CEM
    consumer encodes each state once and scores candidate actions on the
    code, the same Q function with the image tower out of the loop.
    """
    if not (hasattr(self.module, "encode")
            and hasattr(self.module, "q_from_code")):
      return None

    def bound(name):
      def fn(variables, features):
        module = self.thread_module()
        with stateless._reparametrize_module(module, variables, strict=True):
          return getattr(module, name)(features)
      return fn

    return bound("encode"), bound("q_from_code")

  def loss_fn(self, outputs, features,
              labels: Optional[dict]) -> Tuple[torch.Tensor, Metrics]:
    if labels is None:
      raise ValueError("CriticModel.loss_fn requires labels")
    target = labels[self.target_key].float()
    q_logit = outputs["q_predicted"].float().reshape(target.shape)
    if self.loss_type == "cross_entropy":
      # optax.sigmoid_binary_cross_entropy's formula, averaged.
      loss = F.binary_cross_entropy_with_logits(q_logit, target)
      q_prob = torch.sigmoid(q_logit)
      return loss, {
          "bce": loss,
          "q_mean": q_prob.mean(),
          # Grasp-success accuracy at the 0.5 threshold.
          "accuracy": ((q_prob > 0.5) == (target > 0.5)).float().mean(),
      }
    loss = torch.mean(torch.square(q_logit - target))
    return loss, {"mse": loss, "q_mean": q_logit.mean()}
