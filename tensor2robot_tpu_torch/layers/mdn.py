"""Mixture density network heads (multimodal action distributions).

Counterpart of ``tensor2robot_tpu/layers/mdn.py``: diagonal-Gaussian
mixtures over action vectors, VRGripper's behavior-cloning head, written
directly in torch ops (log-probabilities through logsumexp). The JAX
function creates its projection in the caller's flax scope; here the
caller owns the ``Dense`` (``mixture_projection``) and hands it over.

``sample`` draws with a ``torch.Generator``; its draws cannot equal the
JAX package's (threefry against Philox or the CPU's Mersenne Twister), so
it is held to the mixture's moments, not to JAX's samples.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.layers.vision_layers import Dense


class MixtureParams(NamedTuple):
  """Diagonal GMM parameters: shapes (..., K), (..., K, D), (..., K, D)."""
  log_alphas: torch.Tensor
  mus: torch.Tensor
  log_sigmas: torch.Tensor


def mixture_projection(in_features: int, num_components: int,
                       sample_size: int) -> Dense:
  """The float32 Dense that ``predict_mixture_params`` projects through
  (the JAX ``mdn`` layer): K * (2D + 1) outputs."""
  return Dense(in_features, num_components * (2 * sample_size + 1),
               torch.float32)


def predict_mixture_params(inputs: torch.Tensor, num_components: int,
                           sample_size: int,
                           projection: Dense) -> MixtureParams:
  """Projects (..., F) features to the GMM's parameters: K mixture
  logits (log-softmaxed), K means and K softplus-shifted log scales of
  dimension D."""
  k, d = num_components, sample_size
  raw = projection(inputs.float())
  alphas = raw[..., :k]
  rest = raw[..., k:].unflatten(-1, (k, 2 * d))
  # Softplus-shifted sigma, clipped away from zero for stability.
  log_sigmas = torch.log(F.softplus(rest[..., d:]) + 1e-5)
  return MixtureParams(log_alphas=torch.log_softmax(alphas, dim=-1),
                       mus=rest[..., :d], log_sigmas=log_sigmas)


def log_prob(params: MixtureParams, x: torch.Tensor) -> torch.Tensor:
  """GMM log-likelihood of x: (..., D) -> (...)."""
  x = x[..., None, :]  # broadcast over components
  inv_var = torch.exp(-2.0 * params.log_sigmas)
  component_ll = -0.5 * torch.sum(
      (x - params.mus) ** 2 * inv_var + 2.0 * params.log_sigmas
      + math.log(2.0 * math.pi), dim=-1)
  return torch.logsumexp(params.log_alphas + component_ll, dim=-1)


def negative_log_likelihood(params: MixtureParams,
                            x: torch.Tensor) -> torch.Tensor:
  """Mean NLL, the MDN training loss."""
  return -torch.mean(log_prob(params, x))


def _component(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
  """values (..., K, D) at component index (...) -> (..., D)."""
  index = index[..., None, None].expand(
      index.shape + (1, values.shape[-1]))
  return torch.gather(values, -2, index).squeeze(-2)


def gaussian_mixture_approximate_mode(params: MixtureParams) -> torch.Tensor:
  """Mean of the highest-weight component: the deterministic action at
  serving time."""
  return _component(params.mus, torch.argmax(params.log_alphas, dim=-1))


def sample(params: MixtureParams,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
  """Draws one sample per batch element: a component from the mixture
  weights, then a Gaussian draw of its mean and scale."""
  logits = params.log_alphas
  component = torch.multinomial(
      torch.softmax(logits.reshape(-1, logits.shape[-1]), dim=-1), 1,
      generator=generator).reshape(logits.shape[:-1])
  mu = _component(params.mus, component)
  sigma = torch.exp(_component(params.log_sigmas, component))
  return mu + sigma * torch.randn(mu.shape, generator=generator,
                                  device=mu.device, dtype=mu.dtype)
