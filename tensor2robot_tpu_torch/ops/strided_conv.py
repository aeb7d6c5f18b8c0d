"""Folded formulation of the 3x3 stride-2 SAME convolution.

Counterpart of ``tensor2robot_tpu/ops/strided_conv.py``, the QT-Opt
critic's ``impl="fast"`` post-merge convolutions. The JAX package writes
the strided conv as a stride-(2, 1) conv over a view of the input whose W
stride phases live in the channels, to suit the TPU MXU. The port keeps
the same construction, the same SAME offsets (an even size pads (0, 1))
and the same parameters (``kernel`` (3, 3, C, O) in flax, ``weight``
(O, C, 3, 3) here; ``bias``):

  pad x with SAME's lo/hi zeros to (B, 2·HO + 2, 2·WO + 2, C);
  view rows as (B, H_p, W_p / 2, 2C);
  y = conv(view, w_folded, strides=(2, 1), VALID), with
  w_folded[r, s, qC + c, o] = w[r, 2s + q, c, o] for r < 3, 2s + q < 3
  and zero elsewhere.

It is the parity convolution up to float reassociation. Plain torch
(``F.conv2d``), not a hand kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def fold_strided3x3_weights(w: torch.Tensor) -> torch.Tensor:
  """(3, 3, C, O) parity layout -> (4, 2, 2C, O) folded layout."""
  kh, kw, c, o = w.shape
  if (kh, kw) != (3, 3):
    raise ValueError(f"expected a (3, 3, C, O) kernel, got {tuple(w.shape)}")
  zero_row = w.new_zeros((1, 3, c, o))
  zero_col = w.new_zeros((4, 1, c, o))
  # (r, column) with column = 2s + q: row 3 and column 3 are zeros.
  padded = torch.cat([torch.cat([w, zero_row], 0), zero_col], 1)
  return padded.reshape(4, 2, 2, c, o).reshape(4, 2, 2 * c, o)


def strided3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """conv2d(x, w, strides=(2, 2), padding='SAME') via the folded view.

  x: (B, H, W, C); w: (3, 3, C, O), the parity layout.
  """
  b, h, wd, c = x.shape
  out_h, out_w = -(-h // 2), -(-wd // 2)
  lo_h = max((out_h - 1) * 2 + 3 - h, 0) // 2
  lo_w = max((out_w - 1) * 2 + 3 - wd, 0) // 2
  hp, wp = 2 * out_h + 2, 2 * out_w + 2
  x = F.pad(x, (0, 0, lo_w, wp - lo_w - wd, lo_h, hp - lo_h - h))
  view = x.reshape(b, hp, wp // 2, 2 * c).permute(0, 3, 1, 2)
  y = F.conv2d(view, fold_strided3x3_weights(w).permute(3, 2, 0, 1),
               stride=(2, 1))
  return y.permute(0, 2, 3, 1)


class FoldedStridedConv3x3(nn.Conv2d):
  """The drop-in for a SAME 3x3 stride-2 conv, on (B, C, H, W)
  activations, with the parity conv's parameters (``weight`` OIHW, an
  optional ``bias``): parity and folded checkpoints interchange."""

  def __init__(self, in_channels: int, features: int,
               dtype: torch.dtype = torch.bfloat16, bias: bool = True):
    super().__init__(in_channels, features, 3, stride=2, bias=bias)
    self.compute_dtype = dtype

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = self.compute_dtype
    y = strided3x3_same(x.to(dtype).permute(0, 2, 3, 1),
                        self.weight.to(dtype).permute(2, 3, 1, 0))
    y = y.permute(0, 3, 1, 2)
    if self.bias is None:
      return y
    return y + self.bias.to(dtype)[:, None, None]
