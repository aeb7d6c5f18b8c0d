"""ResNet v1 and its FiLM-conditioned variant.

Counterpart of ``tensor2robot_tpu/layers/resnet.py``: the ResNet feature
towers (grasp2vec's ResNet-50) and the variant where a context embedding
modulates every residual block (VRGripper). Images come in as (B, H, W, C)
and the returned spatial map is (B, H, W, C), the JAX layout; inside, the
convolutions run on (B, C, H, W), as ``layers/vision_layers.py`` does.
Parameter names follow the flax tree (``stem_conv``, ``stem_bn``,
``stage{s}_block{b}/{conv1,bn1,conv2,bn2,conv3,bn3,proj_conv,proj_bn}``,
``film/film_proj``, ``classifier``), so the weight bridge maps both.

The stem pools 3x3 at stride 2 with "SAME" padding, which on an even map
pads (0, 1) with -inf, as flax's ``max_pool`` does (torch's symmetric
``padding=1`` would shift the windows).

``remat=True`` rematerializes each block in the backward pass
(``torch.utils.checkpoint``), the counterpart of flax's ``nn.remat``: the
block's parameters go in as explicit inputs and its statistics by
closure, so the recomputation uses the tensors of the functional call
that ran the forward, and BatchNorm leaves its running averages unmoved
while the block runs again (``vision_layers.frozen_statistics``), so
they move once, as in flax. The blocks draw no random numbers, so no RNG state is kept (which a
CUDA graph capture could not read).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tensor2robot_tpu_torch.layers.vision_layers import (
    BatchNorm,
    Conv,
    Dense,
    frozen_statistics,
    make_norm,
    normalize_image,
    same_padding,
)
from tensor2robot_tpu_torch.ops.strided_conv import FoldedStridedConv3x3

# depth -> (block sizes, bottleneck?)
_CONFIGS = {
    18: ((2, 2, 2, 2), False),
    34: ((3, 4, 6, 3), False),
    50: ((3, 4, 6, 3), True),
    101: ((3, 4, 23, 3), True),
}


def _norm(layer: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
  return layer(x, train) if isinstance(layer, BatchNorm) else layer(x)


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
  """flax ``max_pool(x, (w, w), strides=(s, s), padding="SAME")`` of a
  (B, C, H, W) map: -inf padding split as XLA's SAME splits it."""
  x = F.pad(x, same_padding(x.shape[-2:], window, stride),
            value=float("-inf"))
  return F.max_pool2d(x, window, stride)


class _Film(nn.Module):
  """Projects a context embedding to (gamma, beta) for `width` channels:
  ``x * (1 + gamma) + beta``, the identity at init."""

  def __init__(self, context_size: int, width: int, dtype: torch.dtype):
    super().__init__()
    self.film_proj = Dense(context_size, 2 * width, dtype)
    self.compute_dtype = dtype

  def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
    gamma, beta = self.film_proj(context.to(self.compute_dtype)).chunk(2, -1)
    return x * (1.0 + gamma[:, :, None, None]) + beta[:, :, None, None]


class _Block(nn.Module):
  """Basic (2-conv) or bottleneck (3-conv) residual block, optional FiLM.

  ``impl="fast"`` runs the 3x3 stride-2 conv through
  ``ops/strided_conv.FoldedStridedConv3x3``: the same function and
  parameters, another formulation.
  """

  def __init__(self, in_channels: int, width: int, stride: int,
               bottleneck: bool, context_size: Optional[int],
               dtype: torch.dtype, norm_kind: str = "batch",
               impl: str = "parity"):
    super().__init__()
    norm = make_norm(norm_kind, dtype)
    out_width = width * (4 if bottleneck else 1)
    self.bottleneck = bottleneck
    if in_channels != out_width or stride != 1:
      self.proj_conv = Conv(in_channels, out_width, 1, stride, dtype,
                            bias=False)
      self.proj_bn = norm(out_width)
    else:
      self.proj_conv = None

    def conv3x3_strided(cin: int) -> nn.Module:
      if impl == "fast" and stride == 2:
        return FoldedStridedConv3x3(cin, width, dtype, bias=False)
      return Conv(cin, width, 3, stride, dtype, bias=False)

    if bottleneck:
      self.conv1 = Conv(in_channels, width, 1, 1, dtype, bias=False)
      self.bn1 = norm(width)
      self.conv2 = conv3x3_strided(width)
      self.bn2 = norm(width)
      self.conv3 = Conv(width, out_width, 1, 1, dtype, bias=False)
      self.bn3 = norm(out_width)
    else:
      self.conv1 = conv3x3_strided(in_channels)
      self.bn1 = norm(width)
      self.conv2 = Conv(width, out_width, 3, 1, dtype, bias=False)
      self.bn2 = norm(out_width)
    self.film = (None if context_size is None
                 else _Film(context_size, out_width, dtype))

  def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
              train: bool) -> torch.Tensor:
    residual = x
    if self.proj_conv is not None:
      residual = _norm(self.proj_bn, self.proj_conv(x), train)
    y = torch.relu(_norm(self.bn1, self.conv1(x), train))
    y = self.conv2(y)
    if self.bottleneck:
      y = torch.relu(_norm(self.bn2, y, train))
      y = _norm(self.bn3, self.conv3(y), train)
    else:
      y = _norm(self.bn2, y, train)
    if self.film is not None:
      y = self.film(y, context)
    return torch.relu(y + residual)


def _recompute_with_frozen_statistics():
  return contextlib.nullcontext(), frozen_statistics()


def _rematerialized(block: _Block, x: torch.Tensor,
                    context: Optional[torch.Tensor],
                    train: bool) -> torch.Tensor:
  """`block` with its activations recomputed in the backward pass. The
  running averages go in by closure, not as saved inputs: the forward
  moves them in place, and the recomputation only reads batch
  statistics."""
  names, params = zip(*block.named_parameters())
  buffers = dict(block.named_buffers())

  def run(x, context, *params):
    return torch.func.functional_call(
        block, {**dict(zip(names, params)), **buffers}, (x, context, train))

  return checkpoint(run, x, context, *params, use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=_recompute_with_frozen_statistics)


class ResNet(nn.Module):
  """ResNet v1 feature tower; num_classes=0 gives the pooled features.

  ``film=True`` makes every block FiLM-conditioned on a context of
  ``context_size`` features (call with ``context``). ``forward(images,
  context=None, train=False)`` returns the pooled (B, F) features, and
  with ``return_spatial`` also the pre-pool (B, H, W, F) map.
  ``features`` is F.
  """

  def __init__(self, depth: int = 50, width: int = 64, num_classes: int = 0,
               film: bool = False, return_spatial: bool = False,
               remat: bool = False, norm: str = "batch",
               impl: str = "parity", dtype: torch.dtype = torch.bfloat16,
               in_channels: int = 3, context_size: Optional[int] = None):
    super().__init__()
    if depth not in _CONFIGS:
      raise ValueError(f"Unsupported depth {depth}; have {sorted(_CONFIGS)}")
    if film and context_size is None:
      raise ValueError("A FiLM ResNet needs the context's size.")
    block_sizes, bottleneck = _CONFIGS[depth]
    self.film = film
    self.return_spatial = return_spatial
    self.remat = remat
    self.compute_dtype = dtype
    self.stem_conv = Conv(in_channels, width, 7, 2, dtype, bias=False)
    self.stem_bn = make_norm(norm, dtype)(width)
    channels = width
    self.block_names = []
    for stage, num_blocks in enumerate(block_sizes):
      for block in range(num_blocks):
        name = f"stage{stage}_block{block}"
        self.add_module(name, _Block(
            channels, width * 2 ** stage,
            stride=2 if (block == 0 and stage > 0) else 1,
            bottleneck=bottleneck,
            context_size=context_size if film else None, dtype=dtype,
            norm_kind=norm, impl=impl))
        self.block_names.append(name)
        channels = width * 2 ** stage * (4 if bottleneck else 1)
    self.features = channels
    self.classifier = (Dense(channels, num_classes, torch.float32)
                       if num_classes else None)

  def forward(self, images: torch.Tensor,
              context: Optional[torch.Tensor] = None, train: bool = False):
    if self.film and context is None:
      raise ValueError("FiLM ResNet requires a context embedding.")
    x = normalize_image(images, self.compute_dtype).permute(0, 3, 1, 2)
    x = torch.relu(_norm(self.stem_bn, self.stem_conv(x), train))
    x = max_pool_same(x)
    for name in self.block_names:
      block = getattr(self, name)
      if self.remat and torch.is_grad_enabled():
        x = _rematerialized(block, x, context, train)
      else:
        x = block(x, context, train)
    features = torch.mean(x, dim=(2, 3))  # global average pool
    if self.classifier is not None:
      features = self.classifier(features)
    if self.return_spatial:
      return features, x.permute(0, 2, 3, 1)
    return features


def FilmResNet(depth: int = 18, **kwargs) -> ResNet:  # noqa: N802
  """The reference's film_resnet_model: ResNet with FiLM conditioning."""
  return ResNet(depth=depth, film=True, **kwargs)
