"""The port's QT-Opt learner slice held against the JAX package.

The host replay modules (sum tree, ring buffers, ingest, the collector)
are numpy copies: on the same seeds they give the same indices, arrays,
counters, metrics and state_dict arrays, bit for bit. Fleet CEM and the
Bellman targets run TinyQ at float32 through the weight bridge with the
JAX package's own draws injected (threefry and Philox cannot match):
targets within 1e-4. Twenty learner steps from one bit-identical uniform
ring: targets and TD errors within 1e-4, losses within 1e-4 relative,
the first step's gradients within 1e-3 of each tensor's largest, and each
side's first update Adam's rule on its own gradient within 1e-7 (the JAX
side where |g| > 1e-6). The off-policy bar (eval TD error against the
retry env's Q* down 30%) holds at seed 0 on the CPU.
"""

import dataclasses
import json
import os
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has jax but no flax
  import jax
  import jax.numpy as jnp
  import optax
  from tensor2robot_tpu.parallel import mesh as jax_mesh
  from tensor2robot_tpu.replay import (
      bellman as jax_bellman,
      ingest as jax_ingest,
      loop as jax_loop,
      ring_buffer as jax_ring,
      smoke as jax_smoke,
      sum_tree as jax_sum_tree,
  )
  from tensor2robot_tpu.research.qtopt import cem as jax_cem
  from tensor2robot_tpu.specs import tensorspec_utils as jax_ts
  from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
except ImportError:
  jax = None

from tensor2robot_tpu_torch import bridge  # noqa: E402
from tensor2robot_tpu_torch.obs.flight_recorder import (  # noqa: E402
    FlightRecorder,
)
from tensor2robot_tpu_torch.obs.ledger import ExecutableLedger  # noqa: E402
from tensor2robot_tpu_torch.obs.registry import MetricRegistry  # noqa: E402
from tensor2robot_tpu_torch.obs.watchdog import Watchdog  # noqa: E402
from tensor2robot_tpu_torch.replay import (  # noqa: E402
    bellman,
    ingest,
    learner_bench,
    loop,
    ring_buffer,
    smoke,
    sum_tree,
)
from tensor2robot_tpu_torch.research.qtopt import cem  # noqa: E402
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402
from tensor2robot_tpu_torch.utils import optimizers  # noqa: E402

IMG = 8  # tiny transition images for the structural tests
TARGET_ATOL = 1e-4
CEM_ATOL = 1e-5
LOSS_RTOL = 1e-4
GRAD_SHARE = 1e-3


@pytest.fixture
def needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _transition(i, img=IMG, action_size=4, reward=0.0, done=0.0):
  return {
      "image": np.full((img, img, 3), i % 256, np.uint8),
      "action": np.full((action_size,), float(i), np.float32),
      "reward": np.float32(reward),
      "done": np.float32(done),
      "next_image": np.full((img, img, 3), (i + 1) % 256, np.uint8),
  }


def _stack(items):
  return {key: np.stack([item[key] for item in items]) for key in items[0]}


def _random_transitions(n, seed, img=IMG):
  rng = np.random.default_rng(seed)
  return {
      "image": rng.integers(0, 256, (n, img, img, 3), np.uint8),
      "action": rng.uniform(-1, 1, (n, 4)).astype(np.float32),
      "reward": (rng.random(n) < 0.4).astype(np.float32),
      "done": (rng.random(n) < 0.3).astype(np.float32),
      "next_image": rng.integers(0, 256, (n, img, img, 3), np.uint8),
  }


def _assert_same_arrays(got, want):
  assert sorted(got) == sorted(want)
  for key in want:
    np.testing.assert_array_equal(np.asarray(got[key]),
                                  np.asarray(want[key]), err_msg=key)


# --- SumTree ----------------------------------------------------------------


class TestSumTree:

  def test_total_and_proportional_sampling(self):
    tree = sum_tree.SumTree(5)
    tree.set([0, 1, 2, 3, 4], [1.0, 2.0, 3.0, 4.0, 0.0])
    assert tree.total == pytest.approx(10.0)
    rng = np.random.default_rng(0)
    counts = np.bincount(tree.sample(rng.random(20_000)), minlength=5)
    np.testing.assert_allclose(counts / 20_000,
                               [0.1, 0.2, 0.3, 0.4, 0.0], atol=0.02)

  def test_zero_priority_leaf_never_sampled(self):
    tree = sum_tree.SumTree(4)
    tree.set([0, 1, 2, 3], [1.0, 0.0, 2.0, 0.0])
    samples = tree.sample(np.random.default_rng(1).random(5_000))
    assert set(np.unique(samples)) <= {0, 2}

  def test_update_and_renormalization(self):
    rng = np.random.default_rng(2)
    tree = sum_tree.SumTree(33)  # off-power-of-two on purpose
    for _ in range(200):
      idx = rng.integers(0, 33, size=8)
      tree.set(idx, rng.random(8))
    assert tree.total == pytest.approx(tree.leaves(33).sum(), abs=1e-12)
    tree.set(np.arange(33), np.zeros(33))
    assert tree.total == 0.0
    with pytest.raises(ValueError):
      tree.sample(np.array([0.5]))

  def test_duplicate_indices_last_value_wins(self):
    tree = sum_tree.SumTree(4)
    tree.set([2, 2, 2], [5.0, 7.0, 1.0])
    assert tree.get([2])[0] == pytest.approx(1.0)
    assert tree.total == pytest.approx(1.0)

  @pytest.mark.parametrize("indices, values, error", [
      ([4], [1.0], IndexError), ([0], [-1.0], ValueError),
      ([0], [np.nan], ValueError)])
  def test_rejects_bad_inputs(self, indices, values, error):
    with pytest.raises(error):
      sum_tree.SumTree(4).set(indices, values)

  @pytest.mark.parametrize("capacity", [1, 7, 64, 1000])
  def test_bit_identical_to_jax(self, needs_jax, capacity):
    rng = np.random.default_rng(capacity)
    ours, theirs = (sum_tree.SumTree(capacity),
                    jax_sum_tree.SumTree(capacity))
    for _ in range(20):
      idx = rng.integers(0, capacity, 9)
      values = rng.random(9) * rng.integers(0, 3, 9)
      ours.set(idx, values)
      theirs.set(idx, values)
      np.testing.assert_array_equal(ours._tree, theirs._tree)
      if theirs.total > 0:
        uniforms = rng.random(64)
        np.testing.assert_array_equal(ours.sample(uniforms),
                                      theirs.sample(uniforms))
    assert ours.total == theirs.total


# --- ReplayBuffer -----------------------------------------------------------


def _buffer(capacity=4, batch=8, **kwargs):
  return ring_buffer.ReplayBuffer(loop.transition_spec(IMG, 4),
                                  capacity=capacity, sample_batch_size=batch,
                                  seed=0, **kwargs)


class TestReplayBuffer:

  def test_wraparound_overwrite_correctness(self):
    buf = _buffer()
    slots = [buf.append(_transition(i, reward=float(i))) for i in range(6)]
    assert slots == [0, 1, 2, 3, 0, 1]
    assert buf.size == 4 and buf.append_count == 6
    assert buf.fill_fraction == 1.0
    batch, _ = buf.sample()
    assert set(np.asarray(batch["reward"]).tolist()) <= {2.0, 3.0, 4.0, 5.0}
    assert float(buf._storage["reward"][0]) == 4.0

  def test_fixed_batch_shape_even_underfilled(self):
    buf = _buffer(capacity=16, batch=8)
    buf.append(_transition(0))
    batch, info = buf.sample()
    assert np.asarray(batch["image"]).shape == (8, IMG, IMG, 3)
    assert info.indices.shape == (8,)

  def test_seeded_sampling_determinism(self):
    def stream(seed):
      buf = ring_buffer.ReplayBuffer(loop.transition_spec(IMG, 4),
                                     capacity=8, sample_batch_size=4,
                                     seed=seed)
      for i in range(8):
        buf.append(_transition(i))
      return [buf.sample()[1].indices.tolist() for _ in range(5)]

    assert stream(7) == stream(7)
    assert stream(7) != stream(8)

  @pytest.mark.parametrize("change, match", [
      (lambda t: t.update(action=np.zeros((5,), np.float32)), "action"),
      (lambda t: t.update(image=np.zeros((IMG, IMG, 3), np.float32)),
       "castable"),
      (lambda t: t.pop("reward"), "missing"),
      (lambda t: t.update(bogus=np.zeros(1)), "extra")])
  def test_spec_validation_at_the_door(self, change, match):
    transition = _transition(0)
    change(transition)
    with pytest.raises(ValueError, match=match):
      _buffer().append(transition)

  def test_staleness_counts_appends_since_write(self):
    buf = _buffer(capacity=8, batch=4)
    for i in range(8):
      buf.append(_transition(i))
    _, info = buf.sample()
    np.testing.assert_array_equal(info.staleness, 8 - info.indices)

  def test_prioritized_sampling_follows_td_updates(self):
    buf = _buffer(capacity=4, batch=8, prioritized=True,
                  priority_exponent=1.0)
    for i in range(4):
      buf.append(_transition(i))
    buf.update_priorities([0, 1, 2, 3], [0.0, 0.0, 0.0, 10.0])
    _, info = buf.sample()
    assert np.mean(info.indices == 3) > 0.8

  def test_fresh_append_gets_max_priority(self):
    buf = _buffer(capacity=4, batch=8, prioritized=True,
                  priority_exponent=1.0)
    for i in range(3):
      buf.append(_transition(i))
    buf.update_priorities([0, 1, 2], [5.0, 0.0, 0.0])
    buf.append(_transition(3))
    counts = np.zeros(4)
    for _ in range(30):
      _, info = buf.sample()
      counts += np.bincount(info.indices, minlength=4)
    assert counts[3] > counts[1] and counts[3] > counts[2]
    assert counts[3] == pytest.approx(counts[0], rel=0.35)

  def test_priority_entropy_and_metrics(self):
    buf = _buffer(capacity=4, batch=4, prioritized=True,
                  priority_exponent=1.0)
    for i in range(4):
      buf.append(_transition(i))
    uniform_entropy = buf.priority_entropy()
    buf.update_priorities([0, 1, 2, 3], [100.0, 0.0, 0.0, 0.0])
    assert buf.priority_entropy() < uniform_entropy
    assert 0.0 <= buf.priority_entropy() <= 1.0
    for key in ("replay/fill_fraction", "replay/size",
                "replay/append_count", "replay/priority_entropy",
                "replay/provenance/synthetic"):
      assert key in buf.metrics()

  def test_probabilities_and_priorities_are_float32_at_boundary(self):
    for kwargs in ({}, {"prioritized": True}):
      buf = _buffer(capacity=8, batch=4, **kwargs)
      for i in range(8):
        buf.append(_transition(i))
      assert buf.sample()[1].probabilities.dtype == np.float32
    buf = _buffer(capacity=4, batch=4, prioritized=True,
                  priority_exponent=1.0)
    for i in range(4):
      buf.append(_transition(i))
    buf.update_priorities([0], np.asarray([0.5], np.float64))
    buf.update_priorities([1], np.asarray([0.5], np.float32))
    assert buf._tree.get([0])[0] == buf._tree.get([1])[0]

  @pytest.mark.parametrize("n", [3, 6, 11])
  def test_extend_matches_sequential_appends(self, n):
    by_append = _buffer(capacity=4, batch=4, prioritized=True)
    for i in range(n):
      by_append.append(_transition(i, reward=float(i)))
    by_extend = _buffer(capacity=4, batch=4, prioritized=True)
    by_extend.extend(_stack([_transition(i, reward=float(i))
                             for i in range(n)]))
    assert (by_extend._next, by_extend._size, by_extend._append_count) == (
        by_append._next, by_append._size, by_append._append_count)
    np.testing.assert_array_equal(by_extend._written_at,
                                  by_append._written_at)
    _assert_same_arrays(by_extend._storage, by_append._storage)

  def test_state_dict_round_trip_continues_the_stream(self):
    buf = _buffer(capacity=8, batch=4, prioritized=True)
    buf.extend(_random_transitions(11, 0))
    buf.update_priorities([1, 2], [3.0, 0.1])
    arrays, meta = buf.state_dict()
    want = [buf.sample()[1].indices for _ in range(3)]
    restored = _buffer(capacity=8, batch=4, prioritized=True)
    restored.load_state_dict(arrays, meta)
    got = [restored.sample()[1].indices for _ in range(3)]
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="capacity"):
      _buffer(capacity=16, batch=4, prioritized=True).load_state_dict(
          arrays, meta)

  @pytest.mark.parametrize("prioritized", [False, True])
  @pytest.mark.parametrize("capacity, fill", [(16, 5), (16, 40), (50, 77)])
  def test_bit_identical_to_jax(self, needs_jax, prioritized, capacity,
                                fill):
    """Appends and extends with wraparound, per-row provenance, samples,
    priority writes: the same slots, batches, SampleInfo, metrics and
    state_dict on both sides."""
    spec = loop.transition_spec(IMG, 4)
    kwargs = dict(capacity=capacity, sample_batch_size=8, seed=3,
                  prioritized=prioritized)
    ours = ring_buffer.ReplayBuffer(spec, **kwargs)
    theirs = jax_ring.ReplayBuffer(jax_loop.transition_spec(IMG, 4),
                                   **kwargs)
    data = _random_transitions(fill, fill)
    labels = np.where(np.arange(fill) % 3, "synthetic", "served")
    rng = np.random.default_rng(9)
    for side in (ours, theirs):
      side.append({k: v[0] for k, v in data.items()})
      side.extend({k: v[1:] for k, v in data.items()},
                  provenance=labels[1:])
    for _ in range(6):
      (got, got_info), (want, want_info) = ours.sample(), theirs.sample()
      _assert_same_arrays(dict(got), dict(want))
      for field in ("indices", "staleness", "probabilities"):
        a, b = getattr(got_info, field), getattr(want_info, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
      td = rng.random(8).astype(np.float32) * 3
      ours.update_priorities(got_info.indices, td)
      theirs.update_priorities(want_info.indices, td)
    assert ours.metrics() == theirs.metrics()
    (got_arrays, got_meta), (want_arrays, want_meta) = (
        ours.state_dict(), theirs.state_dict())
    _assert_same_arrays(got_arrays, want_arrays)
    assert got_meta == want_meta


# --- ShardedReplayBuffer ----------------------------------------------------


class TestShardedReplayBuffer:

  def test_striped_append_and_global_priority_routing(self):
    buf = ring_buffer.ShardedReplayBuffer(
        loop.transition_spec(IMG, 4), capacity=8, sample_batch_size=4,
        num_shards=2, seed=0, prioritized=True, priority_exponent=1.0)
    slots = [buf.append(_transition(i)) for i in range(8)]
    assert slots == [0, 4, 1, 5, 2, 6, 3, 7]
    batch, _ = buf.sample()
    assert np.asarray(batch["image"]).shape == (4, IMG, IMG, 3)
    buf.update_priorities(np.arange(8), [9, 0, 0, 0, 9, 0, 0, 0])
    assert buf._shards[0]._tree.get([0])[0] > 1.0
    assert buf._shards[1]._tree.get([0])[0] > 1.0
    assert buf._shards[0]._tree.get([1])[0] < 1.0

  @pytest.mark.parametrize("capacity, batch", [(9, 4), (8, 3)])
  def test_divisibility_contracts(self, capacity, batch):
    with pytest.raises(ValueError, match="divisible"):
      ring_buffer.ShardedReplayBuffer(loop.transition_spec(IMG, 4),
                                      capacity=capacity,
                                      sample_batch_size=batch, num_shards=2)

  @pytest.mark.parametrize("prioritized", [False, True])
  @pytest.mark.parametrize("num_shards", [2, 4])
  def test_bit_identical_to_jax(self, needs_jax, prioritized, num_shards):
    kwargs = dict(capacity=32, sample_batch_size=8, num_shards=num_shards,
                  seed=5, prioritized=prioritized)
    ours = ring_buffer.ShardedReplayBuffer(loop.transition_spec(IMG, 4),
                                           **kwargs)
    theirs = jax_ring.ShardedReplayBuffer(jax_loop.transition_spec(IMG, 4),
                                          **kwargs)
    data = _random_transitions(45, 1)
    labels = np.where(np.arange(45) % 4, "synthetic", "served")
    rng = np.random.default_rng(2)
    for side in (ours, theirs):
      for i in range(3):
        side.append({k: v[i] for k, v in data.items()})
      side.extend({k: v[3:] for k, v in data.items()},
                  provenance=labels[3:])
    for _ in range(5):
      (got, got_info), (want, want_info) = ours.sample(), theirs.sample()
      _assert_same_arrays(dict(got), dict(want))
      for field in ("indices", "staleness", "probabilities"):
        np.testing.assert_array_equal(getattr(got_info, field),
                                      getattr(want_info, field))
      td = rng.random(8).astype(np.float32)
      ours.update_priorities(got_info.indices, td)
      theirs.update_priorities(want_info.indices, td)
    assert ours.metrics() == theirs.metrics()
    (got_arrays, got_meta), (want_arrays, want_meta) = (
        ours.state_dict(), theirs.state_dict())
    _assert_same_arrays(got_arrays, want_arrays)
    assert got_meta == want_meta


# --- ingest -----------------------------------------------------------------


def _episode(t=3):
  return {
      "images": np.stack(
          [np.full((IMG, IMG, 3), i, np.uint8) for i in range(t + 1)]),
      "actions": np.zeros((t, 4), np.float32),
      "rewards": np.arange(t, dtype=np.float32),
      "dones": np.zeros((t,), np.float32),
  }


def _batch(lo, hi):
  return _stack([_transition(i) for i in range(lo, hi)])


class TestIngest:

  def test_episode_flattening_aligns_next_image(self):
    transitions = ingest.episode_to_transitions(_episode(3))
    assert len(transitions) == 3
    for i, tr in enumerate(transitions):
      assert tr["image"][0, 0, 0] == i
      assert tr["next_image"][0, 0, 0] == i + 1
      assert tr["reward"] == float(i)

  def test_stream_length_validation(self):
    episode = _episode(3)
    episode["images"] = episode["images"][:3]
    with pytest.raises(ValueError, match="disagree on length"):
      ingest.episode_to_transitions(episode)

  def test_drop_oldest_backpressure_accounting(self):
    queue = ingest.TransitionQueue(capacity=3)
    for i in range(5):
      queue.put(_transition(i))
    assert queue.stats() == {"enqueued": 5, "dropped": 2, "dequeued": 0,
                             "pending": 3}
    drained = queue.drain()
    assert [t["action"][0] for t in drained] == [2.0, 3.0, 4.0]
    stats = queue.stats()
    assert stats["dequeued"] == 3
    assert stats["enqueued"] == (stats["dropped"] + stats["dequeued"]
                                 + stats["pending"])

  def test_drain_batch_single_concatenate(self):
    queue = ingest.TransitionQueue(capacity=8)
    assert queue.drain_batch() is None
    for i in range(5):
      queue.put(_transition(i))
    batch = queue.drain_batch(max_items=3)
    np.testing.assert_array_equal(batch["action"][:, 0], [0.0, 1.0, 2.0])
    assert queue.stats()["dequeued"] == 3 and len(queue) == 2

  def test_batched_put_counts_each_dropped_transition(self):
    queue = ingest.TransitionQueue(capacity=8)
    assert queue.put_batch(_batch(0, 6)) == 6
    queue.put_batch(_batch(6, 12))
    assert queue.stats() == {"enqueued": 12, "dropped": 4, "dequeued": 0,
                             "pending": 8}
    np.testing.assert_array_equal(queue.drain_batch()["action"][:, 0],
                                  np.arange(4, 12, dtype=np.float32))
    queue.put(_transition(99))
    queue.put_batch(_batch(0, 11))
    stats = queue.stats()
    assert stats["dropped"] == 4 + 1 + 3 and stats["pending"] == 8

  def test_empty_episode_is_a_noop(self):
    queue = ingest.TransitionQueue(capacity=4)
    assert queue.put_episode({
        "images": np.zeros((1, 2, 2, 3), np.uint8),
        "actions": np.zeros((0, 4), np.float32),
        "rewards": np.zeros((0,), np.float32),
        "dones": np.zeros((0,), np.float32)}) == 0
    assert len(queue) == 0 and queue.stats()["enqueued"] == 0

  def test_batched_and_scalar_puts_interleave_fifo(self):
    queue = ingest.TransitionQueue(capacity=16)
    queue.put(_transition(0))
    queue.put_batch(_batch(1, 4))
    queue.put(_transition(4))
    assert [t["action"][0] for t in queue.drain(max_items=2)] == [0.0, 1.0]
    np.testing.assert_array_equal(queue.drain_batch()["action"][:, 0],
                                  [2.0, 3.0, 4.0])

  def test_shed_accounting_under_concurrent_put_and_drain(self):
    """enqueued == dropped + dequeued + pending, exactly, while scalar and
    batched producers race the batched drain (short switch interval)."""
    import sys
    queue = ingest.TransitionQueue(capacity=16)
    per_thread, n_threads = 200, 6
    drained_rows = [0]
    stop = threading.Event()

    def producer(tid):
      if tid % 2:
        for i in range(0, per_thread, 5):
          base = tid * per_thread + i
          queue.put_batch(_batch(base, base + 5))
        return
      for i in range(per_thread):
        queue.put(_transition(tid * per_thread + i))

    def consumer():
      while not stop.is_set():
        batch = queue.drain_batch(max_items=8)
        if batch is not None:
          drained_rows[0] += batch["reward"].shape[0]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
      threads = [threading.Thread(target=producer, args=(tid,))
                 for tid in range(n_threads)]
      drainer = threading.Thread(target=consumer)
      drainer.start()
      for thread in threads:
        thread.start()
      for thread in threads:
        thread.join(60)
      stop.set()
      drainer.join(60)
    finally:
      sys.setswitchinterval(interval)
    assert not drainer.is_alive()
    assert not any(thread.is_alive() for thread in threads)
    stats = queue.stats()
    assert stats["enqueued"] == per_thread * n_threads
    assert stats["enqueued"] == (stats["dropped"] + stats["dequeued"]
                                 + stats["pending"])
    assert drained_rows[0] == stats["dequeued"]

  def test_min_fill_gating(self):
    queue = ingest.TransitionQueue(capacity=16)
    feeder = ingest.ReplayFeeder(queue, _buffer(capacity=16, batch=4),
                                 min_fill=3)
    assert not feeder.ready()
    queue.put(_transition(0))
    queue.put(_transition(1))
    feeder.drain()
    assert not feeder.ready()
    queue.put(_transition(2))
    feeder.drain()
    assert feeder.ready()
    assert feeder.metrics()["replay/min_fill_ready"] == 1.0

  def test_min_fill_must_be_reachable(self):
    with pytest.raises(ValueError, match="never open"):
      ingest.ReplayFeeder(ingest.TransitionQueue(capacity=4),
                          _buffer(capacity=4, batch=4), min_fill=5)

  @pytest.mark.parametrize("hook", ["registry", "flight_recorder"])
  def test_obs_hooks_refuse_by_name(self, hook, tmp_path):
    """The queue's obs hooks (they refused until the obs spine was
    ported): every shed row counts into the registry's
    replay/transition_queue_dropped, and 8 consecutive overflowing puts
    dump the recorder once (the streak then restarts)."""
    registry = MetricRegistry()
    recorder = FlightRecorder(dump_dir=str(tmp_path),
                              min_dump_interval_s=0.0)
    hooks = {"registry": registry, "flight_recorder": recorder}
    queue = ingest.TransitionQueue(capacity=4, **{hook: hooks[hook]})
    for i in range(4):
      queue.put(_transition(i))
    for i in range(4, 12):  # each put sheds the oldest row
      queue.put(_transition(i))
    assert queue.dropped == 8
    dumps = sorted(os.listdir(tmp_path))
    if hook == "registry":
      assert registry.counter(
          "replay/transition_queue_dropped").value == 8
      assert dumps == []  # the trigger went to the process recorder
    else:
      assert len(dumps) == 1 and "sustained_overflow" in dumps[0]
      with open(tmp_path / dumps[0]) as f:
        trigger = json.load(f)["trigger"]
      assert trigger == {"consecutive_overflow_puts": 8,
                         "dropped_total": 8, "pending": 4, "capacity": 4}

  def test_queue_and_feeder_bit_identical_to_jax(self, needs_jax):
    """Episodes, scalar and batched puts with drop-oldest slicing and
    mixed provenance, drained through the feeder into a sharded ring."""
    spec_kwargs = dict(capacity=24, sample_batch_size=4, num_shards=2,
                       seed=1, prioritized=True)
    sides = []
    for lib, spec in ((ingest, loop.transition_spec(IMG, 4)),
                      (jax_ingest, jax_loop.transition_spec(IMG, 4))):
      buf_lib = ring_buffer if lib is ingest else jax_ring
      queue = lib.TransitionQueue(capacity=10)
      buffer = buf_lib.ShardedReplayBuffer(spec, **spec_kwargs)
      sides.append((queue, lib.ReplayFeeder(queue, buffer, min_fill=6),
                    buffer))
    data = _random_transitions(30, 4)
    log = [[], []]
    for step in range(6):
      for side, (queue, feeder, buffer) in enumerate(sides):
        queue.put_episode(_episode(step % 4), provenance="served")
        queue.put({k: v[step] for k, v in data.items()})
        queue.put_batch({k: v[5 * step:5 * step + 4]
                         for k, v in data.items()}, provenance="synthetic")
        log[side].append((feeder.drain() if step % 2 else 0,
                          queue.stats(), feeder.ready(), feeder.metrics()))
    assert log[0] == log[1]
    (_, _, ours), (_, _, theirs) = sides
    assert ours.metrics() == theirs.metrics()
    _assert_same_arrays(ours.state_dict()[0], theirs.state_dict()[0])


# --- CollectorWorker and the loop's config ---------------------------------


class TestCollector:

  def test_steps_bit_identical_to_jax(self, needs_jax):
    kwargs = dict(image_size=16, num_envs=4, max_attempts=3, seed=2,
                  grasp_radius=0.4, exploration_epsilon=0.25,
                  scripted_fraction=0.25)
    queues = (ingest.TransitionQueue(10_000),
              jax_ingest.TransitionQueue(10_000))
    ours = loop.CollectorWorker(learner_bench.uniform_policy(4, 1), queues[0], **kwargs)
    theirs = jax_loop.CollectorWorker(learner_bench.uniform_policy(4, 1), queues[1],
                                      **kwargs)
    for env in theirs._envs:  # the JAX worker resets in start()
      env.reset(theirs._scene_seed())
    for _ in range(40):
      ours.step_once()
      theirs.step_once()
    assert (ours.episodes, ours.successes, ours.env_steps) == (
        theirs.episodes, theirs.successes, theirs.env_steps)
    assert ours.episodes > 20 and 0 < ours.successes < ours.episodes
    assert queues[0].stats() == queues[1].stats()
    _assert_same_arrays(queues[0].drain_batch(), queues[1].drain_batch())

  def test_thread_fills_the_queue_and_stops(self):
    queue = ingest.TransitionQueue(10_000)
    worker = loop.CollectorWorker(learner_bench.uniform_policy(4, 0), queue, 16)
    worker.start()
    deadline = time.monotonic() + 60
    while len(queue) < 20 and time.monotonic() < deadline:
      time.sleep(0.01)
    worker.stop()
    assert len(queue) >= 20 and not worker._thread.is_alive()

  def test_thread_error_surfaces_at_stop(self):
    def broken(images):
      raise RuntimeError("policy down")

    worker = loop.CollectorWorker(broken, ingest.TransitionQueue(8), 16)
    worker.start()
    worker._thread.join(30)
    with pytest.raises(RuntimeError, match="collector died"):
      worker.stop()

  @pytest.mark.parametrize("hook", ["flight_recorder", "watchdog"])
  def test_obs_hooks_refuse_by_name(self, hook, tmp_path):
    """The collector's obs hooks (they refused until the obs spine was
    ported): its thread beats an act/collector heartbeat, unregistered
    when it stops, and its death dumps the recorder."""
    if hook == "watchdog":
      watchdog = Watchdog()
      worker = loop.CollectorWorker(learner_bench.uniform_policy(4, 0),
                                    ingest.TransitionQueue(10_000), 16,
                                    watchdog=watchdog)
      worker.start()
      deadline = time.monotonic() + 60
      while (not watchdog.snapshot()["components"].get(
          "act/collector", {}).get("beats")) and time.monotonic() < deadline:
        time.sleep(0.01)
      assert watchdog.snapshot()["components"]["act/collector"]["beats"] > 0
      worker.stop()
      assert watchdog.snapshot()["components"] == {}
      return

    def broken(images):
      raise RuntimeError("policy down")

    recorder = FlightRecorder(dump_dir=str(tmp_path))
    worker = loop.CollectorWorker(broken, ingest.TransitionQueue(8), 16,
                                  flight_recorder=recorder)
    worker.start()
    assert worker.join(30.0)
    with pytest.raises(RuntimeError, match="collector died"):
      worker.stop()
    (dump,) = os.listdir(tmp_path)
    with open(tmp_path / dump) as f:
      payload = json.load(f)
    assert payload["reason"] == "collector_thread_exception"
    assert payload["trigger"]["error"] == "RuntimeError: policy down"

  def test_config_is_the_jax_config_field_for_field(self, needs_jax):
    def fields(cls):
      return [(f.name, f.default if f.default_factory is dataclasses.MISSING
               else f.default_factory()) for f in dataclasses.fields(cls)]

    assert fields(loop.ReplayLoopConfig) == fields(jax_loop.ReplayLoopConfig)

  @pytest.mark.parametrize("tier", ["bf16", "int8"])
  def test_config_takes_the_scoring_tiers(self, tier):
    assert loop.ReplayLoopConfig(precision=tier).precision == tier
    with pytest.raises(ValueError, match="supported tiers"):
      loop.ReplayLoopConfig(precision="fp8")

  def test_eval_transitions_bit_identical_to_jax(self, needs_jax):
    config = loop.ReplayLoopConfig(seed=4, eval_batches=2)
    want_batches, want_stars = jax_loop.ReplayTrainLoop._eval_transitions(
        types.SimpleNamespace(config=jax_loop.ReplayLoopConfig(
            seed=4, eval_batches=2)))
    got_batches, got_stars = loop.eval_transitions(config)
    for got, want in zip(got_batches, want_batches):
      _assert_same_arrays(got, want)
    np.testing.assert_array_equal(got_stars, want_stars)


# --- fleet CEM and the Bellman updater -------------------------------------


def _tiny(seed=0, image_size=IMG, **kwargs):
  """JAX and port TinyQ with the same random weights (bridged)."""
  jax_model = jax_smoke.TinyQCriticModel(image_size=image_size, **kwargs)
  model = smoke.TinyQCriticModel(image_size=image_size, **kwargs)
  variables = jax.device_get(
      jax_model.init_variables(jax.random.key(seed), batch_size=2))
  return jax_model, model, variables, bridge.variables_to_state_dict(
      variables, model.module)


def _jax_label_noise(seed, seeds, iterations, samples, action_size=4):
  """The JAX updater's draws: state b's iteration i is normal(fold_in(
  fold_in(key(seed), seeds[b]), i), (N, A))."""
  base = jax.random.key(seed)
  keys = jax.vmap(lambda s: jax.random.fold_in(base, s))(
      jnp.asarray(np.asarray(seeds, np.uint32)))
  return np.stack([np.asarray(jax.vmap(
      lambda k, i=i: jax.random.normal(jax.random.fold_in(k, i),
                                       (samples, action_size)))(keys))
                   for i in range(iterations)], axis=1)


def _bellman_batch(n=6, seed=0, reward=None, done=None, img=IMG):
  batch = _random_transitions(n, seed, img)
  if reward is not None:
    batch["reward"] = np.asarray(reward, np.float32)
  if done is not None:
    batch["done"] = np.asarray(done, np.float32)
  return batch


CEM_KNOBS = dict(num_samples=8, num_elites=2, iterations=2)


def _updaters(seed=0, **kwargs):
  jax_model, model, variables, state = _tiny(seed)
  theirs = jax_bellman.BellmanUpdater(jax_model, variables, action_size=4,
                                      gamma=0.8, seed=7, **CEM_KNOBS,
                                      **kwargs)
  ours = bellman.BellmanUpdater(model, state, action_size=4, gamma=0.8,
                                seed=7, device="cpu", **CEM_KNOBS, **kwargs)
  return (jax_model, variables, theirs), (model, state, ours)


class TestFleetCEM:

  def test_fleet_matches_jax_with_its_draws(self, needs_jax):
    jax_model, model, variables, state = _tiny(1)
    images = _random_transitions(5, 2)["image"]
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(3), s))(
        jnp.arange(5, dtype=jnp.uint32))
    want, want_scores = jax_cem.fleet_cem_optimize(
        jax_cem.make_tiled_q_score_fn(jax_model.predict_fn, variables),
        jnp.asarray(images), keys, 4, num_samples=16, num_elites=4,
        iterations=3)
    noise = np.stack([np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(k, i), (16, 4))) for i in range(3)])
                      for k in keys])
    got, got_scores = cem.fleet_cem_optimize(
        cem.make_batched_tiled_q_score_fn(model.predict_fn, state),
        torch.from_numpy(images), torch.from_numpy(noise), 4,
        num_samples=16, num_elites=4, iterations=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=CEM_ATOL)
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               rtol=0, atol=CEM_ATOL)

  @pytest.mark.parametrize("batch", [1, 3, 5])
  def test_batched_equals_per_state(self, batch):
    model = smoke.TinyQCriticModel(image_size=IMG)
    state = model.init_variables(torch.Generator().manual_seed(0),
                                 device="cpu")
    images = torch.from_numpy(_random_transitions(5, 3)["image"])[:batch]
    noise = torch.randn((5, 3, 16, 4),
                        generator=torch.Generator().manual_seed(1))[:batch]
    calls = []

    def score(states, actions):
      calls.append(actions.shape[:2])
      return cem.make_batched_tiled_q_score_fn(model.predict_fn, state)(
          states, actions)

    best, scores = cem.fleet_cem_optimize(
        score, images, noise, 4, num_samples=16, num_elites=4,
        iterations=3)
    # One forward of B*N images per iteration, then the final scoring of
    # each mean.
    assert calls == [(batch, 16)] * 3 + [(batch, 1)]
    per_state = cem.make_tiled_q_score_fn(model.predict_fn, state)
    for i in range(batch):
      want, want_score = cem.cem_optimize(
          lambda a, i=i: per_state(images[i], a), None, 4, num_samples=16,
          num_elites=4, iterations=3, noise=noise[i])
      np.testing.assert_allclose(best[i].numpy(), want.numpy(), rtol=0,
                                 atol=1e-6)
      assert float(scores[i]) == pytest.approx(float(want_score), abs=1e-6)

  def test_noise_shape_is_checked(self):
    with pytest.raises(ValueError, match="noise must be"):
      cem.fleet_cem_optimize(None, torch.zeros(2, 3), torch.zeros(2, 3, 8, 4),
                             4, num_samples=8, iterations=2)


class TestBellmanUpdater:

  def test_targets_match_jax_with_its_draws(self, needs_jax):
    (_, _, theirs), (_, _, ours) = _updaters()
    for seed in (0, 1):
      batch = _bellman_batch(6, seed, reward=[1, 0, 1, 0, 0, 1],
                             done=[1, 0, 0, 0, 1, 1])
      want, want_q = theirs.compute_targets(batch)
      seeds = np.arange(6 * seed, 6 * seed + 6)
      got, got_q = ours.compute_targets(
          batch, noise=_jax_label_noise(7, seeds, 2, 8))
      np.testing.assert_allclose(got, want, rtol=0, atol=TARGET_ATOL)
      np.testing.assert_allclose(got_q, want_q, rtol=0, atol=TARGET_ATOL)
    assert ours.next_label_seed == theirs.next_label_seed == 12

  def test_factored_targets_match_jax_with_its_draws(self, needs_jax):
    jax_model, model, variables, state = _tiny(2)
    batch = _bellman_batch(5, 3)
    args = (4, 0.8, 8, 2, 2, True)
    seeds = np.arange(5, dtype=np.uint32)
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(7), s))(
        jnp.asarray(seeds))
    tiled_want, _ = jax_bellman.make_bellman_targets_fn(
        jax_model, *args)(variables, batch["next_image"], batch["reward"],
                          batch["done"], keys)
    want, want_q = jax_bellman.make_bellman_targets_fn(
        jax_model, *args, factored=True)(
            variables, batch["next_image"], batch["reward"], batch["done"],
            keys)
    noise = torch.from_numpy(_jax_label_noise(7, seeds, 2, 8))
    with torch.inference_mode():
      got, got_q = bellman.make_bellman_targets_fn(
          model, *args, factored=True)(
              state, torch.from_numpy(batch["next_image"]),
              torch.from_numpy(batch["reward"]),
              torch.from_numpy(batch["done"]), noise)
      tiled, _ = bellman.make_bellman_targets_fn(model, *args)(
          state, torch.from_numpy(batch["next_image"]),
          torch.from_numpy(batch["reward"]),
          torch.from_numpy(batch["done"]), noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TARGET_ATOL)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=0,
                               atol=TARGET_ATOL)
    np.testing.assert_allclose(tiled.numpy(), np.asarray(tiled_want),
                               rtol=0, atol=TARGET_ATOL)
    np.testing.assert_allclose(tiled.numpy(), got.numpy(), rtol=0, atol=1e-5)

  def test_label_is_independent_of_batch_composition(self):
    model = smoke.TinyQCriticModel(image_size=IMG)
    state = model.init_variables(torch.Generator().manual_seed(3),
                                 device="cpu")
    updater = bellman.BellmanUpdater(model, state, gamma=0.8, seed=1,
                                     device="cpu", **CEM_KNOBS)
    batch = _bellman_batch(6, 5)
    together, _ = updater.compute_targets(batch, seeds=np.arange(10, 16))
    for i in range(6):
      alone, _ = updater.compute_targets({k: v[i:i + 1]
                                          for k, v in batch.items()},
                                         seeds=[10 + i])
      np.testing.assert_allclose(alone, together[i:i + 1], rtol=0,
                                 atol=1e-6)
    order = np.array([4, 0, 5, 2, 1, 3])
    shuffled, _ = updater.compute_targets(
        {k: v[order] for k, v in batch.items()}, seeds=10 + order)
    np.testing.assert_allclose(shuffled, together[order], rtol=0, atol=1e-6)
    # The default seeds come from the counter; the same seeds, the same
    # draws.
    first, _ = updater.compute_targets(batch)
    again, _ = updater.compute_targets(batch, seeds=np.arange(6))
    np.testing.assert_array_equal(first, again)
    assert updater.next_label_seed == 6

  def test_done_masks_bootstrap_and_clip(self):
    model = smoke.TinyQCriticModel(image_size=IMG)
    state = model.init_variables(torch.Generator().manual_seed(0),
                                 device="cpu")
    updater = bellman.BellmanUpdater(model, state, gamma=0.8, seed=0,
                                     device="cpu", **CEM_KNOBS)
    batch = _bellman_batch(4, reward=[1, 1, 0, 0], done=[1, 1, 0, 0])
    targets, q_next = updater.compute_targets(batch)
    np.testing.assert_allclose(targets[:2], [1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(targets[2:], 0.8 * q_next[2:], atol=1e-6)
    assert np.all(targets >= 0) and np.all(targets <= 1)
    mse = smoke.TinyQCriticModel(image_size=IMG, loss_type="mse")
    unclipped = bellman.BellmanUpdater(mse, state, gamma=0.8, seed=0,
                                       device="cpu", **CEM_KNOBS)
    targets, q_next = unclipped.compute_targets(
        _bellman_batch(4, reward=[3, 3, 0, 0], done=[1, 0, 0, 0]))
    np.testing.assert_allclose(targets, [3, 3, 0, 0] + 0.8 * np.array(
        [0, 1, 1, 1]) * q_next, rtol=1e-6)
    assert targets[0] == 3.0

  def test_refresh_swaps_variables_without_rebuilding(self):
    model = smoke.TinyQCriticModel(image_size=IMG)
    state = model.init_variables(torch.Generator().manual_seed(0),
                                 device="cpu")
    updater = bellman.BellmanUpdater(model, state, gamma=0.8, seed=0,
                                     device="cpu", **CEM_KNOBS)
    batch = _bellman_batch(4)
    before, _ = updater.compute_targets(batch, seeds=np.arange(4))
    updater.td_errors(state, batch, np.zeros(4, np.float32))
    bumped = {k: v + 0.05 for k, v in state.items()}
    updater.refresh(bumped, step=10)
    after, _ = updater.compute_targets(batch, seeds=np.arange(4))
    updater.td_errors(bumped, batch, np.zeros(4, np.float32))
    assert updater.compile_counts == {"bellman_targets": 1, "td_error": 1}
    assert updater.target_lag(25) == 15 and updater.refresh_count == 1
    assert not np.array_equal(before, after)

  @pytest.mark.parametrize("polyak_tau", [None, 0.25])
  def test_target_network_matches_jax(self, needs_jax, polyak_tau):
    jax_model, model, variables, state = _tiny(4)
    theirs = jax_bellman.TargetNetwork(variables, polyak_tau=polyak_tau)
    ours = bellman.TargetNetwork(state, polyak_tau=polyak_tau,
                                 device="cpu")
    for step in (3, 9):
      online = jax.tree_util.tree_map(
          lambda x, s=step: np.asarray(x) * (1 + 0.1 * s) + 0.01 * s,
          variables)
      theirs.refresh(online, step)
      ours.refresh(bridge.variables_to_state_dict(online, model.module),
                   step)
      want = bridge.variables_to_state_dict(
          jax.device_get(theirs._target_variables), model.module)
      for key, value in ours._target_variables.items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=1e-7, atol=1e-7, err_msg=key)
      assert ours.target_lag(12) == theirs.target_lag(12)
      assert ours.refresh_count == theirs.refresh_count
    saved, meta = ours.target_state()
    restored = bellman.TargetNetwork(device="cpu")
    restored.restore_target_state(saved, meta)
    assert meta == theirs.target_state()[1]
    for key, value in ours._target_variables.items():
      np.testing.assert_array_equal(restored._target_variables[key].numpy(),
                                    value.numpy())

  def test_td_errors_and_eval_match_jax(self, needs_jax):
    (_, variables, theirs), (_, state, ours) = _updaters(5)
    config = loop.ReplayLoopConfig(image_size=IMG, eval_batches=2)
    batches, stars = loop.eval_transitions(config)
    want = jax_loop.ReplayTrainLoop._eval(None, theirs, variables, batches,
                                          stars)
    got = loop.evaluate_td(ours, state, batches, stars)
    assert got == pytest.approx(want, abs=1e-6)
    assert ours.compile_counts == {"td_error": 1}

  def test_refusals_name_their_items(self):
    model = smoke.TinyQCriticModel(image_size=IMG)
    state = model.init_variables(torch.Generator().manual_seed(0),
                                 device="cpu")
    # sharding= places the target where its spec says: whole on every
    # rank under the replicated sharding the fused learners pass.
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    placed = bellman.TargetNetwork(
        state, sharding=mesh_lib.replicated_sharding(
            mesh_lib.create_mesh({"data": 1}, devices=[0])), device="cpu")
    for key, value in placed.target_state()[0].items():
      np.testing.assert_array_equal(value, state[key].numpy(), err_msg=key)
    # The bf16 tier, once item 11's refusal: one label at the tier,
    # float32 and clipped; ledger=, once item 15b-i's, takes the label
    # closure at the tier with its FLOPs and the call.
    book = ExecutableLedger()
    updater = bellman.BellmanUpdater(model, state, precision="bf16",
                                     ledger=book, device="cpu", **CEM_KNOBS)
    targets, q_next = updater.compute_targets(_bellman_batch(3, 1))
    row, = book.attribution()["executables"]
    assert (row["name"], row["dtype"], row["compiles"],
            row["dispatches"]) == ("bellman_targets", "bf16", 1, 1)
    assert row["flops_per_dispatch"] > 0
    assert updater.precision == "bf16"
    assert targets.dtype == q_next.dtype == np.float32
    assert targets.min() >= 0.0 and targets.max() <= 1.0
    from tensor2robot_tpu_torch.research.qtopt import t2r_models
    with pytest.raises(ValueError, match="no factored CEM form"):
      bellman.make_bellman_targets_fn(t2r_models.QTOptGraspingModel(), 4,
                                      0.8, 8, 2, 2, True, factored=True)


# --- the learner ------------------------------------------------------------


class TestLearner:

  def test_twenty_uniform_steps_match_jax(self, needs_jax):
    """The host learner step on both sides from one bit-identical uniform
    ring and one init, the port labelling with the JAX draws: the same
    sampled indices, targets and TD errors within TARGET_ATOL, losses
    within LOSS_RTOL; the first step's gradients and each side's Adam
    update."""
    lr, size, batch_size, steps = 3e-3, 16, 32, 20
    jax_model = jax_smoke.TinyQCriticModel(
        image_size=size, optimizer_fn=lambda: optax.adam(lr))
    model = smoke.TinyQCriticModel(
        image_size=size, optimizer_fn=optimizers.create_adam_optimizer(lr))
    jax_trainer = JaxTrainer(
        jax_model, mesh=jax_mesh.create_mesh(devices=jax.devices()[:1]),
        seed=0)
    jax_state = jax_trainer.create_train_state(batch_size=batch_size)
    initial = jax.device_get(jax_state.variables())
    trainer = Trainer(model, device="cpu")
    state = trainer.create_train_state(initial)
    data = _random_transitions(256, 11, img=size)
    buffers = (ring_buffer.ReplayBuffer(loop.transition_spec(size, 4), 256,
                                        batch_size, seed=2),
               jax_ring.ReplayBuffer(jax_loop.transition_spec(size, 4), 256,
                                     batch_size, seed=2))
    for buffer in buffers:
      buffer.extend(data)
    knobs = dict(action_size=4, gamma=0.8, num_samples=16, num_elites=4,
                 iterations=2, seed=13)
    theirs = jax_bellman.BellmanUpdater(jax_model, initial, **knobs)
    ours = bellman.BellmanUpdater(model, state.variables(), device="cpu",
                                  **knobs)
    names = list(state.params)
    losses, want_losses = [], []
    for step in range(1, steps + 1):
      batch, info = buffers[1].sample()
      targets, _ = theirs.compute_targets(batch)
      sharded = jax_trainer.shard_batch((
          {"image": batch["image"], "action": batch["action"]},
          {"target_q": targets}))
      before = jax.device_get(jax_state.params)
      jax_state, metrics = jax_trainer.train_step(jax_state, *sharded)
      want_losses.append(float(metrics["loss"]))
      want_td = theirs.td_errors(jax_state.variables(), batch, targets)

      got_batch, got_info = buffers[0].sample()
      np.testing.assert_array_equal(got_info.indices, info.indices)
      seeds = np.arange((step - 1) * batch_size, step * batch_size)
      got_targets, _ = ours.compute_targets(
          got_batch, noise=_jax_label_noise(13, seeds, 2, 16))
      np.testing.assert_allclose(got_targets, targets, rtol=0,
                                 atol=TARGET_ATOL)
      old = {n: state.params[n].detach().clone() for n in names}
      state, got_metrics = trainer.train_step(
          state, {"image": torch.from_numpy(got_batch["image"]),
                  "action": torch.from_numpy(got_batch["action"])},
          {"target_q": torch.from_numpy(got_targets)})
      losses.append(float(got_metrics["loss"]))
      np.testing.assert_allclose(
          ours.td_errors(state.variables(), got_batch, got_targets),
          want_td, rtol=0, atol=TARGET_ATOL)
      if step == 1:
        self._check_first_step(jax_model, before, initial, batch, targets,
                               jax.device_get(jax_state.params), model,
                               state, old, lr)
      if step % 10 == 0:
        theirs.refresh(jax.device_get(jax_state.variables()), step)
        ours.refresh(state.variables(), step)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert ours.compile_counts == {"bellman_targets": 1, "td_error": 1}

  @staticmethod
  def _check_first_step(jax_model, before, initial, batch, targets, after,
                        model, state, old, lr):
    """Gradients within GRAD_SHARE of each tensor's largest; each side's
    update is Adam's first step, -lr g / (|g| + eps), on its own g."""
    rest = {k: v for k, v in initial.items() if k != "params"}

    def loss_fn(params):
      loss, _ = jax_model.model_train_fn(
          {"params": params, **rest},
          jax_ts.TensorSpecStruct({"image": batch["image"],
                                   "action": batch["action"]}),
          jax_ts.TensorSpecStruct({"target_q": targets}))
      return loss

    want_grads = bridge.params_to_state_dict(
        jax.device_get(jax.grad(loss_fn)(before)), model.module)
    want_update = bridge.params_to_state_dict(
        jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                               after, before), model.module)
    for name, param in state.params.items():
      grad = param.grad.numpy()
      want = want_grads[name].numpy()
      np.testing.assert_allclose(grad, want, rtol=0,
                                 atol=GRAD_SHARE * np.abs(want).max(),
                                 err_msg=name)
      # The port's update against its own gradient everywhere; the JAX
      # update against a gradient recomputed outside its step, so only
      # where |g| >> eps (near eps, summation order moves g / (|g| + eps)).
      rule = -lr * grad / (np.abs(grad) + 1e-8)
      np.testing.assert_allclose((param.detach() - old[name]).numpy(), rule,
                                 rtol=0, atol=1e-7, err_msg=name)
      large = np.abs(want) > 1e-6
      np.testing.assert_allclose(
          want_update[name].numpy()[large],
          (-lr * want / (np.abs(want) + 1e-8))[large], rtol=0, atol=1e-7,
          err_msg=name)

  def test_off_policy_bar_on_the_cpu(self):
    result = learner_bench.off_policy_td_reduction(seed=0, device="cpu")
    assert result["eval_td_reduction"] >= 0.30, result
    assert result["ring_size"] == 512 and result["refreshes"] == 20
    assert result["final_eval"]["eval_q_loss"] < result["initial_eval"][
        "eval_q_loss"]
    assert result["compile_counts"] == {"bellman_targets": 1, "td_error": 1}

  def test_throughput_bench_host_path(self):
    result = learner_bench.measure_learner_throughput(
        steps_per_trial=4, inner_steps=2, trials=2, device="cpu")
    assert result["device"] == "cpu"
    assert result["host_path"]["train_steps_per_sec"]["trials"] == 2
    assert 0.0 <= result["host_path"]["host_blocked_fraction"]["median"] <= 1
    # Since the megastep exists, the bench times it beside the host path.
    assert result["device_megastep"]["train_steps_per_sec"]["trials"] == 2
    assert result["speedup"]["trials"] == 2
    assert result["compile_counts"] == {"bellman_targets": 1, "td_error": 1,
                                        "megastep": 1, "device_extend": 1}

  def test_stage_clock_counts_steps_and_stages(self):
    config = loop.ReplayLoopConfig(capacity=64, min_fill=32, batch_size=8)
    buffer, worker, feeder = learner_bench.fill_ring(config)
    assert feeder.ready() and buffer.size == 64 and worker.episodes > 0
    model = smoke.TinyQCriticModel()
    trainer = Trainer(model, device="cpu")
    state = trainer.create_train_state()
    updater = bellman.BellmanUpdater(model, state.variables(), device="cpu",
                                     **CEM_KNOBS)
    clock = learner_bench.StageClock(trainer.device)
    for _ in range(3):
      state, _, td = learner_bench.host_learner_step(trainer, updater,
                                                     buffer, state, clock)[:3]
    summary = clock.summary()
    assert clock.steps == 3 and td.shape == (8,)
    assert list(summary) == list(learner_bench.STAGES)
    assert all(v["host_ms"] > 0 and v["device_ms"] is None
               for v in summary.values())


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU")
  return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_labels_match_cpu(cuda_device):
  """The same draws label the same targets on the card and the CPU."""
  model = smoke.TinyQCriticModel()
  state = model.init_variables(torch.Generator().manual_seed(0),
                               device="cpu")
  batch = _bellman_batch(32, 1, img=16)
  labels = [bellman.BellmanUpdater(model, state, gamma=0.8, seed=3,
                                   device=device).compute_targets(batch)
            for device in ("cpu", cuda_device)]
  np.testing.assert_allclose(labels[1][0], labels[0][0], rtol=0, atol=1e-4)
