"""CEMFleetPolicy: the QT-Opt control step batched across clients.

Counterpart of ``tensor2robot_tpu/serving/policy.py``. One program per
ladder bucket runs the whole fleet control step (image tiling, every CEM
iteration, scoring through the Q-function, the elite refits) for up to
``bucket`` clients at once. On the GPU that program is a CUDA graph,
captured once per (bucket, shapes, dtypes) and replayed: the counterpart
of the JAX package's one AOT executable per bucket. On the CPU the same
control runs eagerly, and ``compile_counts`` counts each bucket's first
build, so the exactly-once ledger means the same thing there.

**Parameters are an argument, not baked in.** The policy keeps one copy
of the served variables on the device, and every bucket's graph reads it.
A hot reload (a new ``predictor.model_version``) copies the new variables
into that copy, under the policy's lock, at the first call that sees the
new version; no graph is captured again, so ``compile_counts[bucket]``
stays 1 for the life of the policy.

**Per-request draws.** Request ``s`` draws its (iterations, N, A) block
from ``np.random.default_rng((policy_seed, s))`` (``cem.seeded_noise``),
so its action depends only on (image, seed, variables), never on which
requests shared the flush, its position there or the bucket's padding.
threefry's ``fold_in`` cannot be matched; a test passes the JAX draws
through ``noise=``.

**Staging.** Each bucket copies its requests and draws up through one
pinned host buffer each, and its actions and scores back the same way:
two copies up, one graph replay and two copies down a call, under one
lock with one wait at the end.

**Scoring tier.** One policy serves one ``precision``
(``research/qtopt/cem.py``): every bucket's graph scores at it. Under
"int8" the policy's own copy holds the int8 weights and their scales,
quantized when the variables are placed; a hot reload quantizes into
those tensors, and each replay dequantizes them. The host path, which
scores through ``predict``, serves "f32" only and refuses another tier.

**Placement.** ``device=`` pins the served copy, the graphs and the
staging to one ``torch.device``; ``label=`` names the replica in ledger
keys (the fleet router runs several replicas on one card, so a device
alone does not name one). On the GPU every call runs on the policy's own
stream, so two replicas' replays may overlap on the card, and the rungs
of one policy share one graph memory pool (``share_graph_pool``): one
lock serialises their replays, so a rung's intermediates may reuse
another's memory, and each graph's outputs stay held. ``warm`` captures
the largest rung first, so the smaller ones fit in what it freed.

**The candidate override.** ``policy(..., variables=cand)`` scores a
rollout candidate through the same graphs, with no new capture: the
candidate is placed once on the device (a cache keyed on the tree's
identity; quantized under int8), and under the policy's lock copied into
the served copy, replayed, and the live variables copied back. A
``ledger`` (``obs/ledger.py``) gets one registration a build, keyed
``cem_bucket_<b>[_<tier>]@<label>``, with the FLOPs of the build's first
eager control step (the capture's first warm-up on the GPU), and one
dispatch a call.

Waiting for a later ``ROADMAP.md`` item, and refused by name:
``param_specs=`` (a tensor-parallel replica group, item 15b).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from tensor2robot_tpu_torch.ops import graph_launches
from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.serving import bucketing
from tensor2robot_tpu_torch.serving.bucketing import BucketLadder


def _clone(value):
  """A copy of one served tensor, or of a quantized weight's pair."""
  if isinstance(value, dict):
    return {key: tensor.detach().clone() for key, tensor in value.items()}
  return value.detach().clone()


def _copy_into(target, value) -> None:
  """Copies a served tensor, or a quantized weight's pair, into the
  policy's own."""
  if isinstance(target, dict):
    for key, tensor in target.items():
      tensor.copy_(value[key])
  else:
    target.copy_(value)


class _Graph:
  """One bucket's CUDA graph with its static device inputs and outputs
  and their pinned host staging buffers."""

  def __init__(self, images: torch.Tensor, noise: torch.Tensor):
    self.images = images
    self.noise = noise
    self.host_images = torch.empty_like(images, device="cpu",
                                        pin_memory=True)
    self.host_noise = torch.empty_like(noise, device="cpu", pin_memory=True)
    self.graph = torch.cuda.CUDAGraph()
    self.done = torch.cuda.Event()
    self.tally = self.best = self.scores = None
    self.host_actions = self.host_scores = None


class CEMFleetPolicy:
  """Batched CEM serving policy over any predictor with ``q_predicted``.

  Callable: ``policy(images, seeds=None) -> (n, action_size) actions``,
  n = len(images) <= ladder.max_batch. Without a device-resident entry
  (``predictor.device_fn``) the policy serves through ``predict``: the
  request batch padded to its bucket once, one ``predict`` a CEM
  iteration at that one flat shape.
  """

  def __init__(self, predictor, action_size: int = 4,
               num_samples: int = 64, num_elites: int = 6,
               iterations: int = 3, seed: int = 0,
               ladder: Optional[BucketLadder] = None,
               device=None, ledger=None, precision: str = "f32",
               param_specs=None, label: Optional[str] = None):
    if param_specs is not None:
      raise NotImplementedError(
          "CEMFleetPolicy(param_specs=) shards the served critic over a "
          "tensor-parallel replica group, which waits for ROADMAP.md's "
          "flagship item 15b (the loop's parallel tier).")
    self.precision = cem.validate_precision(precision)
    self._predictor = predictor
    self._action_size = action_size
    self._num_samples = num_samples
    self._num_elites = num_elites
    self._iterations = iterations
    self._seed = seed
    self.ladder = ladder or BucketLadder()
    self.device = None if device is None else torch.device(device)
    self.label = (label if label is not None
                  else None if device is None else str(self.device))
    self._ledger = ledger
    # (bucket, image shape, image dtype) -> its _Graph on the GPU, None
    # on the CPU.
    self._buckets: Dict[Tuple, Optional[_Graph]] = {}
    # bucket -> builds; each stays 1 for the life of the policy.
    self.compile_counts: Dict[int, int] = {}
    self._served = None  # the policy's own copy of the served variables
    self._served_version = None
    # id(tree) -> (tree, version, placed): the live variables and at most
    # a rollout candidate and their priors, placed once each.
    self._placements: Dict[int, tuple] = {}
    # The rungs share one graph pool unless this is set False before the
    # first capture.
    self.share_graph_pool = True
    self._pool = None
    self._stream = None
    # One re-entrant lock over builds, hot-reload copies, overrides and
    # every call's copy-in, replay and copy-out (re-entrant so that a
    # router holding every policy's lock can still warm one); request
    # seeds have their own, so clients assigning seeds never wait behind
    # a capture.
    self.lock = threading.RLock()
    self._seed_lock = threading.Lock()
    self._next_seed = 0

  @property
  def executable_buckets(self) -> Sequence[int]:
    return sorted(self.compile_counts)

  def assign_seeds(self, n: int) -> np.ndarray:
    """n fresh monotonic request seeds (thread-safe)."""
    with self._seed_lock:
      start = self._next_seed
      self._next_seed += n
    return np.arange(start, start + n, dtype=np.uint32)

  def warm(self, make_image, sizes: Optional[Sequence[int]] = None) -> None:
    """Builds the ladder's buckets (`sizes`, default every rung), largest
    first, by serving `make_image(i)` frames at each (answers discarded,
    request seeds untouched). Built buckets make this a no-op walk."""
    for bucket in sorted(self.ladder.sizes if sizes is None else sizes,
                         reverse=True):
      self([make_image(i) for i in range(bucket)],
           np.arange(bucket, dtype=np.uint32))

  def noise_for(self, seeds) -> np.ndarray:
    """(n, iterations, N, A) draws of requests `seeds`."""
    return cem.seeded_noise(self._seed, seeds, self._iterations,
                            self._num_samples, self._action_size)

  def ledger_key(self, bucket: int) -> str:
    """The bucket's row in the executable ledger (the JAX key form)."""
    tier = f"_{self.precision}" if self.precision != "f32" else ""
    suffix = f"@{self.label}" if self.label is not None else ""
    return f"cem_bucket_{bucket}{tier}{suffix}"

  def __call__(self, images: Sequence[np.ndarray],
               seeds: Optional[Sequence[int]] = None, *,
               variables=None, return_scores: bool = False,
               noise: Optional[np.ndarray] = None):
    """The control step for `images`: (n, A) actions, and with
    ``return_scores`` ``(actions, scores)``, the selected actions' Q
    scores (the host path has none: ``(actions, None)``). `variables`
    scores those variables in place of the predictor's live ones through
    the same graphs; `noise` (n, iterations, N, A) replaces the seeds'
    draws."""
    batch = np.stack([np.asarray(image) for image in images])
    n = batch.shape[0]
    seeds = (self.assign_seeds(n) if seeds is None
             else np.asarray(seeds, np.uint32))
    if seeds.shape != (n,):
      raise ValueError(f"need {n} seeds, got shape {seeds.shape}")
    noise = self.noise_for(seeds) if noise is None else np.asarray(
        noise, np.float32)
    want = (n, self._iterations, self._num_samples, self._action_size)
    if noise.shape != want:
      raise ValueError(f"noise must be {want}, got {noise.shape}")
    padded, bucket = self.ladder.pad_batch(batch)
    padded_noise = bucketing.pad_to(noise, bucket)
    version = self._predictor.model_version  # read before the variables
    try:
      fn, live = self._predictor.device_fn()
    except NotImplementedError:
      if variables is not None:
        raise ValueError(
            "variables override requires the predictor's device path "
            "(the host fallback scores through predictor.predict, whose "
            "params cannot be swapped per call).") from None
      actions = self._host_call(padded, padded_noise)[:n]
      return (actions, None) if return_scores else actions
    device = self._device_for(live)
    start = time.perf_counter()
    with self.lock, self._on_stream(device):
      self._serve(live, version, device)
      if variables is None:
        actions, scores = self._run(bucket, fn, padded, padded_noise)
      else:
        self._install(self._placed(variables, None, device))
        try:
          actions, scores = self._run(bucket, fn, padded, padded_noise)
        finally:
          self._install(self._placed(live, version, device))
          if device.type == "cuda":
            # The copy back reads tensors that other streams own: done
            # before the lock is released.
            torch.cuda.current_stream(device).synchronize()
    if self._ledger is not None:
      self._ledger.record_dispatch(self.ledger_key(bucket),
                                   time.perf_counter() - start)
    return (actions[:n], scores[:n]) if return_scores else actions[:n]

  # -- the device path -------------------------------------------------------

  def _device_for(self, live) -> torch.device:
    """The pinned device, else the live variables' own."""
    if self.device is not None:
      return self.device
    first = next(iter(live.values()))
    return torch.as_tensor(first).device

  @contextlib.contextmanager
  def _on_stream(self, device: torch.device):
    """On the GPU, the policy's own stream, ordered after the caller's
    work (a hot reload's copies); nothing on the CPU."""
    if device.type != "cuda":
      yield
      return
    if self._stream is None:
      self._stream = torch.cuda.Stream(device)
    self._stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(self._stream):
      yield

  def _placed(self, variables, version, device: torch.device):
    """The served form of `variables` on the policy's device (tensors from
    any array; quantized under the int8 tier), placed once per tree and
    version: the live variables after each reload, a rollout candidate
    once. A candidate changed in place is not seen: pass a new tree."""
    key = id(variables)
    entry = self._placements.get(key)
    if entry is not None and entry[0] is variables and entry[1] == version:
      return entry[2]
    placed = {k: torch.as_tensor(v).to(device) for k, v in variables.items()}
    if self.precision == "int8":
      placed = cem.quantize_scoring_variables(placed)
    if len(self._placements) >= 4:  # live + candidate + their priors
      self._placements.clear()
    self._placements[key] = (variables, version, placed)
    return placed

  def _serve(self, live, version, device: torch.device) -> None:
    """Copies the predictor's variables into the policy's own copy when
    its version moved (under the lock): a hot reload, no rebuild. Under
    int8 the copy holds the quantized weights, and a reload quantizes
    into them."""
    if self._served is None:
      self._served = {k: _clone(v) for k, v in
                      self._placed(live, version, device).items()}
    elif version != self._served_version:
      self._install(self._placed(live, version, device))
    self._served_version = version

  def _install(self, placed) -> None:
    """Copies placed variables into the served copy the graphs read: the
    same keys, shapes and dtypes, or ValueError before any copy."""
    if placed.keys() != self._served.keys():
      raise ValueError(
          f"served variables changed keys: {sorted(placed)} against "
          f"{sorted(self._served)}")
    for key, target in self._served.items():
      pairs = (target.items() if isinstance(target, dict)
               else [(None, target)])
      for part, tensor in pairs:
        value = placed[key] if part is None else placed[key][part]
        if value.shape != tensor.shape or value.dtype != tensor.dtype:
          raise ValueError(
              f"variables[{key!r}] is {tuple(value.shape)} {value.dtype}; "
              f"the graphs read {tuple(tensor.shape)} {tensor.dtype}")
    with torch.no_grad():
      for key, value in placed.items():
        _copy_into(self._served[key], value)

  def _control(self, fn, images: torch.Tensor, noise: torch.Tensor):
    """The fleet control step over the served copy: ((B, A) actions,
    (B,) their scores)."""
    score = cem.make_batched_tiled_q_score_fn(fn, self._served,
                                              self.precision)
    return cem.fleet_cem_optimize(
        score, images, noise, self._action_size,
        num_samples=self._num_samples, num_elites=self._num_elites,
        iterations=self._iterations, precision=self.precision)

  @contextlib.contextmanager
  def _registering(self, bucket: int):
    """A bucket's build: with a ledger, counts the FLOPs of the eager
    control step run inside and registers the bucket with them."""
    if self._ledger is None:
      yield
      return
    with FlopCounterMode(display=False) as flops:
      yield
    self._ledger.register(
        self.ledger_key(bucket), device=self.label, dtype=self.precision,
        shapes={"bucket": bucket, "num_samples": self._num_samples,
                "iterations": self._iterations},
        flops=flops.get_total_flops())

  def _capture(self, bucket: int, fn, padded: torch.Tensor,
               padded_noise: torch.Tensor) -> _Graph:
    """The bucket's graph: two eager warm-up steps (cuDNN's and cuBLAS's
    choices, the allocator), then the capture, into the policy's shared
    pool unless ``share_graph_pool`` is off. Both run on the policy's own
    stream: the caching allocator hands a freed block only to work on the
    stream that freed it, so rungs captured on one stream reuse each
    other's pool blocks, and rungs captured on fresh streams could not."""
    entry = _Graph(padded.clone(), padded_noise.clone())
    if self.share_graph_pool and self._pool is None:
      self._pool = torch.cuda.graph_pool_handle()
    pool = self._pool if self.share_graph_pool else None
    with torch.inference_mode():
      with self._registering(bucket):
        self._control(fn, entry.images, entry.noise)
      self._control(fn, entry.images, entry.noise)
      with graph_launches.capture(entry.graph, self._stream,
                                  pool=pool) as entry.tally:
        entry.best, entry.scores = self._control(fn, entry.images,
                                                 entry.noise)
    entry.host_actions = torch.empty_like(entry.best, device="cpu",
                                          pin_memory=True)
    entry.host_scores = torch.empty_like(entry.scores, device="cpu",
                                         pin_memory=True)
    return entry

  def _run(self, bucket: int, fn, padded: np.ndarray,
           padded_noise: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One call of the bucket's program (under the lock): built at the
    bucket's first call, then replayed on the GPU, run eagerly on the
    CPU."""
    key = (bucket, padded.shape[1:], padded.dtype)
    first = next(iter(self._served.values()))
    device = (next(iter(first.values())) if isinstance(first, dict)
              else first).device
    images = torch.from_numpy(padded)
    noise = torch.from_numpy(padded_noise)
    built = key not in self._buckets
    if built:
      self.compile_counts[bucket] = self.compile_counts.get(bucket, 0) + 1
      self._buckets[key] = (self._capture(bucket, fn, images.to(device),
                                          noise.to(device))
                            if device.type == "cuda" else None)
    entry = self._buckets[key]
    if entry is None:
      with torch.inference_mode(), (self._registering(bucket) if built
                                    else contextlib.nullcontext()):
        best, scores = self._control(fn, images.to(device),
                                     noise.to(device))
      return best.cpu().numpy(), scores.cpu().numpy()
    entry.host_images.copy_(images)
    entry.host_noise.copy_(noise)
    entry.images.copy_(entry.host_images, non_blocking=True)
    entry.noise.copy_(entry.host_noise, non_blocking=True)
    entry.graph.replay()
    graph_launches.replayed(entry.tally)
    entry.host_actions.copy_(entry.best, non_blocking=True)
    entry.host_scores.copy_(entry.scores, non_blocking=True)
    entry.done.record()
    entry.done.synchronize()
    return entry.host_actions.numpy().copy(), entry.host_scores.numpy().copy()

  # -- host fallback ---------------------------------------------------------

  def _host_call(self, padded: np.ndarray,
                 padded_noise: np.ndarray) -> np.ndarray:
    """predict()-based fleet CEM over the padded batch: one ``predict`` a
    CEM iteration at the one flat (bucket * N) shape, the same refits and
    draws as the device path. It serves the f32 tier only."""
    if self.precision != "f32":
      raise ValueError(
          f"scoring precision {self.precision!r} requires the "
          "predictor's device path (device_fn): the host fallback "
          "scores through predictor.predict, whose compute dtype "
          "cannot be retiered per policy. Of the supported tiers "
          f"{cem.SCORING_PRECISIONS} only 'f32' can serve host-side; "
          "serve the f32 tier, or use a device-resident predictor.")
    b, num = padded.shape[0], self._num_samples
    tiled = np.repeat(padded, num, axis=0)

    def score(actions: torch.Tensor) -> torch.Tensor:
      outputs = self._predictor.predict({
          "image": tiled,
          "action": actions.reshape(b * num, -1).numpy()})
      return torch.from_numpy(
          np.asarray(outputs["q_predicted"], np.float32).reshape(b, num))

    best = cem._search(score, torch.from_numpy(padded_noise),
                       self._num_elites,
                       torch.zeros((b, self._action_size)), 0.5, -1.0, 1.0)
    return best.numpy()
