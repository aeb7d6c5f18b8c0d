"""Grasp2Vec losses: n-pairs metric learning.

Counterpart of ``tensor2robot_tpu/research/grasp2vec/losses.py``: the
n-pairs loss on (phi(pre) - phi(post), phi(outcome)) pairs with an L2
embedding regularizer.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def npairs_loss(anchors: torch.Tensor, positives: torch.Tensor,
                l2_reg: float = 2e-3) -> Tuple[torch.Tensor, torch.Tensor]:
  """N-pairs loss: each anchor's positive is the same-index row; every
  other row of the batch is its negative.

  Args:
    anchors: (B, D) embeddings (here phi(pre) - phi(post)).
    positives: (B, D) embeddings (here phi(outcome)).
    l2_reg: weight of the mean squared-embedding regularizer (the
      tf.contrib npairs `reg_lambda`).

  Returns:
    (loss, accuracy): the scalar loss and the batch's retrieval accuracy.
  """
  anchors, positives = anchors.float(), positives.float()
  logits = anchors @ positives.T  # (B, B) similarity
  labels = torch.arange(anchors.shape[0], device=anchors.device)
  ce = F.cross_entropy(logits, labels)
  reg = (torch.mean(torch.sum(torch.square(anchors), -1))
         + torch.mean(torch.sum(torch.square(positives), -1)))
  accuracy = torch.mean((torch.argmax(logits, dim=-1) == labels).float())
  return ce + l2_reg * reg, accuracy
