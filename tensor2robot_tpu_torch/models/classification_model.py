"""ClassificationModel: the softmax cross-entropy task head.

Counterpart of ``tensor2robot_tpu/models/classification_model.py``. The
module's outputs hold ``logits`` of shape (batch, num_classes).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    Metrics,
)


class ClassificationModel(AbstractT2RModel):
  """Softmax classification against class ids or one-hot labels.

  Args:
    label_key: flat key of the label tensor in the label spec.
    output_key: key of the logits in the module outputs.
  """

  def __init__(self, label_key: str = "label", output_key: str = "logits",
               **kwargs):
    super().__init__(**kwargs)
    self.label_key = label_key
    self.output_key = output_key

  def loss_fn(self, outputs, features,
              labels: Optional[dict]) -> Tuple[torch.Tensor, Metrics]:
    if labels is None:
      raise ValueError("ClassificationModel.loss_fn requires labels")
    logits = outputs[self.output_key].float()
    class_ids = labels[self.label_key]
    # By dtype, not rank: integer labels of shape (B,) or (B, 1) are class
    # ids; float labels must be one-hot or soft distributions.
    if not class_ids.is_floating_point():
      class_ids = class_ids.reshape(logits.shape[:-1]).long()
      xent = F.cross_entropy(logits, class_ids)
      accuracy = torch.mean(
          (torch.argmax(logits, -1) == class_ids).float())
    else:
      if class_ids.shape != logits.shape:
        raise ValueError(
            f"Float labels must be one-hot with shape {tuple(logits.shape)},"
            f" got {tuple(class_ids.shape)}; integer class ids must use an "
            "int dtype.")
      xent = torch.mean(torch.sum(
          -class_ids.float() * F.log_softmax(logits, -1), -1))
      accuracy = torch.mean(
          (torch.argmax(logits, -1) == torch.argmax(class_ids, -1)).float())
    return xent, {"cross_entropy": xent, "accuracy": accuracy}
