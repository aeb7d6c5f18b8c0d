"""Folded space-to-depth stem convolution.

Counterpart of ``tensor2robot_tpu/ops/stem_conv.py``. The JAX package
writes the QT-Opt critic's ``stem_kind="space_to_depth"`` stem (an 8x8
window at stride 4 over the image) as one standard convolution over a
reshaped view of the image, to fill the TPU MXU's input lanes. The port
keeps the same function over the same folded weight layout, so the two
packages load each other's ``stem_s2d_kernel``:

  rows = zero-pad x to (B, H + 4, W·C + 4C), viewed as
         (B, H + 4, W/4 + 1, 4C)            (reshapes only)
  y[b, jo, wo, o] = Σ_{r<8, s<2, m<4C}
      rows[b, 4·jo + r, wo + s, m] · w[r, s, m, o]

an (8, 2)-kernel, stride-(4, 1) convolution with 4C input channels. Here
it is one ``F.conv2d``: a torch function, not a hand kernel (the JAX
package computes it outside any Pallas kernel too).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_R = 8  # kernel rows (2 stride-4 row blocks)
_S = 2  # kernel column blocks


def folded_s2d_stem(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """Space-to-depth stem conv: (B, H, W, C) -> (B, ⌈H/4⌉, ⌈W/4⌉, O).

  Sizes that are not multiples of 4 are zero-padded up first, as the JAX
  op does. `w` is the (8, 2, 4C, O) folded layout.
  """
  b, h, wd, c = x.shape
  if tuple(w.shape[:3]) != (_R, _S, 4 * c):
    raise ValueError(f"weights must be ({_R}, {_S}, {4 * c}, O) for C={c}, "
                     f"got {tuple(w.shape)}")
  pad_h, pad_w = (-h) % 4, (-wd) % 4
  if pad_h or pad_w:
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
  jo, wo = (h + pad_h) // 4, (wd + pad_w) // 4
  rows = F.pad(x.reshape(b, 4 * jo, wo * 4 * c), (0, 4 * c, 0, 4))
  folded = rows.reshape(b, 4 * (jo + 1), wo + 1, 4 * c).permute(0, 3, 1, 2)
  y = F.conv2d(folded, w.permute(3, 2, 0, 1), stride=(4, 1))
  return y.permute(0, 2, 3, 1)


def init_folded_stem_weights(c: int, o: int,
                             generator: Optional[torch.Generator] = None,
                             dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
  """Lecun-normal init over the (8, 2, 4C, O) folded layout: the JAX
  op's rule (a plain normal over sqrt(fan_in)), drawn from `generator`."""
  fan_in = _R * _S * 4 * c
  return (torch.randn((_R, _S, 4 * c, o), generator=generator)
          / math.sqrt(fan_in)).to(dtype)
