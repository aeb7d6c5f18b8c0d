"""The executable ledger through the QT-Opt loops, held against the JAX package.

Both packages in one process: each loop path (host, device-resident,
Anakin) runs its smoke config with TinyQ for STEPS optimizer steps, the
JAX loop on the CPU over a one-device mesh and the port's with
``device="cpu"``. Per path, the port's ledger (the result's
``obs.attribution``) against the JAX loop's ``obs_ledger``:

- the same program names, every one built once, each row's ``dtype`` and
  ``shapes`` equal;
- the learner-side programs' dispatch counts equal. The acting buckets
  (``cem_bucket_*``) are replayed by the collector threads and the
  device ring's ``device_extend`` drains what those threads delivered, so
  both counts depend on thread timing: they are held to at least 1;
- the result's ``obs`` block and its attribution carry JAX's keys, and
  the learner-side shares of the run's window sum to at most 1.0 (the
  Anakin path, one thread, whole).

FLOPs: the port counts matrix products and convolutions over a whole call
(``FlopCounterMode``); XLA's ``cost_analysis`` adds elementwise work and
counts a loop body once. So ``td_error`` (one forward) sits within 5%
below JAX's, and ``bellman_targets``, whose CEM scores ``iterations``
rounds of N samples and then the final mean while XLA's ``fori_loop``
body counts one round, sits within 5% below JAX's times (iterations * N +
1) / (N + 1). The megastep's count is K learn iterations: K times the
host path's ``train_step`` + ``bellman_targets`` + ``td_error``, exactly.

The tier ledgers: ``measure_precision``'s and ``measure_tpquant``'s
against the JAX benches' agreement ledgers at the same buckets (the same
``compile_counts`` keys, every value 1).
"""

import tempfile

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has jax but no flax
  import jax
  import optax
  from tensor2robot_tpu.bin import run_qtopt_replay as jax_cli
  from tensor2robot_tpu.obs import ledger as jax_ledger
  from tensor2robot_tpu.replay import loop as jax_loop
  from tensor2robot_tpu.replay import precision_bench as jax_precision
  from tensor2robot_tpu.replay import smoke as jax_smoke
  from tensor2robot_tpu.replay import tpquant_bench as jax_tpquant
except ImportError:
  jax = None

from tensor2robot_tpu_torch.bin import run_qtopt_replay  # noqa: E402
from tensor2robot_tpu_torch.obs import ledger  # noqa: E402
from tensor2robot_tpu_torch.replay import precision_bench  # noqa: E402
from tensor2robot_tpu_torch.replay import tpquant_bench  # noqa: E402

STEPS = 30
PATHS = {"host": {}, "device": {"device_resident": True},
         "anakin": {"anakin": True}}
# Dispatch counts that follow the collector threads' timing.
TIMED = ("cem_bucket_", "device_extend")
FLOPS_BELOW_JAX = 0.95  # the port's count over JAX's (scaled), at least
TIER_BUCKETS = {"bf16": (1, 2, 4), "int8": (4,)}


def _learner_side(name: str) -> bool:
  return not name.startswith("cem_bucket_")


def _rows(attribution) -> dict:
  return {row["name"]: row for row in attribution["executables"]}


@pytest.fixture(scope="module")
def runs():
  """{path: (port result, JAX result, JAX rows)}: one run a path a
  package."""
  if jax is None:
    pytest.skip("needs JAX, the reference")
  out = {}
  for path, options in PATHS.items():
    config = jax_cli.build_config(True, 0, mesh=(1, 1), **options)
    model = jax_smoke.TinyQCriticModel(
        image_size=config.image_size, action_size=config.action_size,
        optimizer_fn=lambda: optax.adam(config.learning_rate))
    theirs = jax_loop.ReplayTrainLoop(config, tempfile.mkdtemp(),
                                      model=model)
    jax_result = theirs.run(STEPS)
    ours = run_qtopt_replay.run(
        STEPS, smoke=True, logdir=tempfile.mkdtemp(), seed=0, device="cpu",
        learner_bench=False, anakin_bench=False, **options)
    out[path] = (ours, jax_result, _rows(theirs.obs_ledger.attribution()))
  return out


@pytest.mark.parametrize("path", list(PATHS))
class TestLoopLedgers:

  def test_names_builds_dtypes_and_shapes_equal_jax(self, runs, path):
    ours, _, theirs = runs[path]
    rows = _rows(ours["obs"]["attribution"])
    assert sorted(rows) == sorted(theirs)
    ledger.check_compile_ledger({name: row["compiles"]
                                 for name, row in rows.items()})
    for name, row in rows.items():
      assert (row["dtype"], row["shapes"]) == (
          theirs[name]["dtype"], theirs[name]["shapes"]), name

  def test_learner_dispatches_equal_jax(self, runs, path):
    ours, _, theirs = runs[path]
    rows = _rows(ours["obs"]["attribution"])
    for name, row in rows.items():
      if name.startswith(TIMED):
        assert row["dispatches"] >= 1, row
      else:
        assert row["dispatches"] == theirs[name]["dispatches"], name

  def test_obs_block_has_the_jax_keys_and_bounded_shares(self, runs, path):
    ours, jax_result, _ = runs[path]
    assert set(ours["obs"]) == set(jax_result["obs"])
    attribution = ours["obs"]["attribution"]
    want = jax_result["obs"]["attribution"]
    assert set(attribution) == set(want)
    assert {key for row in attribution["executables"] for key in row} == {
        key for row in want["executables"] for key in row}
    assert attribution["device_kind"] == "cpu"
    assert attribution["wall_seconds"] > 0
    # Threads overlap on the host and device paths: only the learner's
    # side is held to the window; the Anakin path has one thread.
    held = [row for row in attribution["executables"]
            if path == "anakin" or _learner_side(row["name"])]
    assert sum(row["device_time_share"] for row in held) <= 1.0
    assert ours["compile_counts"] == jax_result["compile_counts"]


def test_flops_against_cost_analysis(runs):
  host, _, theirs = runs["host"]
  rows = _rows(host["obs"]["attribution"])
  flops = {name: rows[name]["flops_per_dispatch"]
           for name in ("train_step", "bellman_targets", "td_error")}
  ratio = flops["td_error"] / theirs["td_error"]["flops_per_dispatch"]
  assert FLOPS_BELOW_JAX <= ratio <= 1.0, ratio
  config = run_qtopt_replay.build_config(True, 0)
  n, rounds = config.cem_num_samples, config.cem_iterations
  ratio = (flops["bellman_targets"]
           / theirs["bellman_targets"]["flops_per_dispatch"]
           / ((rounds * n + 1) / (n + 1)))
  assert FLOPS_BELOW_JAX <= ratio <= 1.0, ratio
  device, _, _ = runs["device"]
  megastep = _rows(device["obs"]["attribution"])["megastep"]
  assert megastep["flops_per_dispatch"] == (
      config.megastep_inner * sum(flops.values()))
  anakin, _, _ = runs["anakin"]
  assert _rows(anakin["obs"]["attribution"])["anakin_step"][
      "flops_per_dispatch"] > 0


@pytest.mark.parametrize("tier", list(TIER_BUCKETS))
def test_tier_ledger_equals_jax(tier):
  if jax is None:
    pytest.skip("needs JAX, the reference")
  buckets = TIER_BUCKETS[tier]
  if tier == "bf16":
    ours = precision_bench.measure_precision(
        buckets=buckets, corpus_scenes=16, fused_loop=False, device="cpu")
  else:
    ours = tpquant_bench.measure_tpquant(
        buckets=buckets, corpus_scenes=16, flagship_image_size=64,
        device="cpu")
  tier_ledger = ours["tier_ledger"]
  assert tier_ledger["per_tier_exactly_once"] is True
  assert set(tier_ledger["tier_shares"]) == {"f32", tier}
  # The JAX benches' phase at the same buckets (the keys do not depend
  # on how far the critic was trained).
  model, variables, _ = jax_precision._pretrain_critic(
      16, 4, 0.8, 0.4, 4, 64, 0)
  book = jax_ledger.ExecutableLedger()
  if tier == "bf16":
    jax_precision._measure_agreement(
        model, variables, buckets, 16, jax_precision.R14_Q_TOL,
        jax_precision.R14_GEO_TOL, 16, 4, 2, 4, 16, 0, book)
  else:
    jax_tpquant._measure_int8_agreement(
        model, variables, buckets, 16, jax_tpquant.R17_Q_TOL, 16, 4, 2, 4,
        16, 0, book)
  assert tier_ledger["compile_counts"] == book.compile_counts
