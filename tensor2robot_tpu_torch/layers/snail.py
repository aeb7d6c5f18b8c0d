"""SNAIL building blocks: temporal convs + causal attention.

Counterpart of ``tensor2robot_tpu/layers/snail.py`` (Mishra et al.'s
Simple Neural AttentIve meta-Learner blocks), on (B, T, D) sequences.
Submodules keep the flax names (``Conv_0``, ``filter``/``gate``,
``dense{i}``, ``key``/``query``/``value``), so the weight bridge maps the
two trees path for path. Unlike flax, a module is told its input width
when it is built; ``TCBlock`` and ``AttentionBlock`` give their output
width as ``out_features``.

Numerics follow flax: parameters stay in float32; convs and dense layers
cast input, kernel and bias to the compute dtype; the dense attention core
takes its logits and softmax in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.vision_layers import Dense
from tensor2robot_tpu_torch.ops.flash_attention import flash_attention
from tensor2robot_tpu_torch.parallel.ring_attention import ring_attention


class CausalConv(nn.Module):
  """1D dilated causal convolution over (B, T, D): left pad, valid conv."""

  def __init__(self, in_features: int, features: int, kernel_size: int = 2,
               dilation: int = 1, dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.pad = dilation * (kernel_size - 1)
    self.Conv_0 = nn.Conv1d(in_features, features, kernel_size,
                            dilation=dilation)
    self.compute_dtype = dtype

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype, conv = self.compute_dtype, self.Conv_0
    x = F.pad(x.to(dtype).transpose(1, 2), (self.pad, 0))
    y = F.conv1d(x, conv.weight.to(dtype), conv.bias.to(dtype),
                 dilation=conv.dilation)
    return y.transpose(1, 2)


class DenseBlock(nn.Module):
  """Gated causal conv whose output is concatenated to its input
  (WaveNet-style gating: tanh * sigmoid)."""

  def __init__(self, in_features: int, filters: int, dilation: int,
               dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.filter = CausalConv(in_features, filters, dilation=dilation,
                             dtype=dtype)
    self.gate = CausalConv(in_features, filters, dilation=dilation,
                           dtype=dtype)
    self.compute_dtype = dtype

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    activations = torch.tanh(self.filter(x)) * torch.sigmoid(self.gate(x))
    return torch.cat([x.to(self.compute_dtype), activations], dim=-1)


class TCBlock(nn.Module):
  """Stack of DenseBlocks with dilations 1, 2, 4, ... covering seq_len."""

  def __init__(self, in_features: int, seq_len: int, filters: int,
               dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.seq_len = seq_len
    self.num_blocks = int(math.ceil(math.log2(max(seq_len, 2))))
    for i in range(self.num_blocks):
      self.add_module(f"dense{i}", DenseBlock(in_features, filters, 2 ** i,
                                              dtype))
      in_features += filters
    self.out_features = in_features

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if x.shape[1] > self.seq_len:
      raise ValueError(
          f"TCBlock(seq_len={self.seq_len}) got length-{x.shape[1]} "
          "input; the dilation schedule would not cover it.")
    for i in range(self.num_blocks):
      x = getattr(self, f"dense{i}")(x)
    return x


class AttentionBlock(nn.Module):
  """Single-head causal attention; output concatenated to input.

  ``use_flash`` runs the core through ``ops.flash_attention`` (K2 forward,
  K3 and K4 backward on the card): O(T) device memory instead of the
  (B, T, T) scores. It needs key_size == value_size and is first order
  only. ``seq_mesh`` runs the core as ring attention
  (``parallel.ring_attention``) with the sequence split over the mesh's
  `seq_axis` (and the batch over `batch_axis` on dp x sp meshes); the
  block's input and output stay whole on every rank.
  """

  def __init__(self, in_features: int, key_size: int, value_size: int,
               dtype: torch.dtype = torch.bfloat16, use_flash: bool = False,
               seq_mesh=None, seq_axis: str = "seq", batch_axis=None):
    super().__init__()
    if use_flash and seq_mesh is not None:
      raise ValueError(
          "use_flash is the in-device core; for sequence-parallel "
          "attention seq_mesh alone selects ring_attention.")
    if use_flash and key_size != value_size:
      raise ValueError(
          "use_flash requires key_size == value_size (one head dim); "
          f"got {key_size} vs {value_size}.")
    self.key = Dense(in_features, key_size, dtype)
    self.query = Dense(in_features, key_size, dtype)
    self.value = Dense(in_features, value_size, dtype)
    self.key_size = key_size
    self.use_flash = use_flash
    self.seq_mesh, self.seq_axis, self.batch_axis = (seq_mesh, seq_axis,
                                                     batch_axis)
    self.compute_dtype = dtype
    self.out_features = in_features + value_size

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = self.compute_dtype
    keys, queries, values = self.key(x), self.query(x), self.value(x)
    if self.use_flash:
      read = flash_attention(queries[:, :, None, :], keys[:, :, None, :],
                             values[:, :, None, :], causal=True)[:, :, 0, :]
    elif self.seq_mesh is not None:
      read = ring_attention(
          queries[:, :, None, :], keys[:, :, None, :], values[:, :, None, :],
          mesh=self.seq_mesh, axis=self.seq_axis, causal=True,
          batch_axis=self.batch_axis)[:, :, 0, :]
    else:
      # float32 logits and softmax: attention normalisation is
      # precision-sensitive even at short T.
      t = x.shape[1]
      logits = torch.einsum("btk,bsk->bts", queries, keys).float()
      logits = logits / math.sqrt(self.key_size)
      mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
      logits = logits.masked_fill(~mask, -1e30)
      weights = torch.softmax(logits, dim=-1).to(dtype)
      read = torch.einsum("bts,bsv->btv", weights, values)
    return torch.cat([x.to(dtype), read], dim=-1)
