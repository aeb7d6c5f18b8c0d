"""Several steps a dispatch and gradient accumulation in the port.

On the CPU, at image 32 and batch 8: ``Trainer.train_steps`` over a
K-stack equals K ``train_step`` calls bit for bit (parameters, Adam
moments, EMA, batch statistics), a final partial stack included, and a
learning-rate schedule whose boundary falls inside a stack steps as it
does one step at a time (the CUDA graph refuses a schedule by name);
``train_step_accum`` matches the JAX ``Trainer.train_step_accum`` at
float32 on pose_env, whose BatchNorm statistics thread through the
microbatches; ``train_eval_model`` runs ``iterations_per_loop`` and
``gradient_accumulation_steps`` to their end and resumes bit for bit; the
capability CLI and the port's ``qtopt_train.cfg`` run through their
``main``. The tests marked ``cuda`` hold a captured graph against eager
steps on the card and skip without one.
"""

import gc
import importlib
import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has none, and runs the cuda tests only
  import jax
  from tensor2robot_tpu import config as jax_config
  from tensor2robot_tpu.bin import run_t2r_trainer as jax_cli
  from tensor2robot_tpu.research.pose_env import (
      pose_env_models as jax_models,
  )
  from tensor2robot_tpu.specs import tensorspec_utils as jax_ts
  from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
except ImportError:
  jax = None

from tensor2robot_tpu_torch import bridge, config  # noqa: E402
from tensor2robot_tpu_torch.bin import (  # noqa: E402
    run_capability_checks,
    run_t2r_trainer,
)
from tensor2robot_tpu_torch.data.abstract_input_generator import (  # noqa: E402
    AbstractInputGenerator,
)
from tensor2robot_tpu_torch.ops import graph_launches  # noqa: E402
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    pose_env,
    pose_env_models,
)
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    synthetic_grasping,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts  # noqa: E402
from tensor2robot_tpu_torch.train import train_eval  # noqa: E402
from tensor2robot_tpu_torch.train.trainer import (  # noqa: E402
    Trainer,
    check_graphable,
)
from tensor2robot_tpu_torch.utils import optimizers  # noqa: E402
from tensor2robot_tpu_torch.utils.tree import tree_map  # noqa: E402

IMAGE, BATCH = 32, 8
LR = 1e-4
# Port vs JAX at float32: the same sums in another order. A conv bias
# that feeds train-mode BatchNorm has an exact gradient of 0, so both
# sides' are rounding noise, which Adam's first step turns into a step of
# up to 1.011 LR either way (tests/test_torch_train.py derives it).
F32_ATOL = 1e-5
ADAM_STEP = 1.011 * LR
BN_FED_BIASES = ("tower.conv0.bias", "tower.conv1.bias", "tower.conv2.bias")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_QTOPT_CFG = os.path.join(_REPO_ROOT, "tensor2robot_tpu", "research",
                             "qtopt", "configs", "qtopt_train.cfg")
PORT_QTOPT_CFG = os.path.join(_REPO_ROOT, "tensor2robot_tpu_torch",
                              "research", "qtopt", "configs",
                              "qtopt_train.cfg")


@pytest.fixture(autouse=True)
def _clean_configs():
  """Bindings are process-wide in both packages: none leaks in or out."""
  config.clear_config()
  if jax is not None:
    jax_config.clear_config()
  yield
  config.clear_config()
  if jax is not None:
    jax_config.clear_config()


def _needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _model(schedule=None, **kwargs):
  return pose_env_models.PoseEnvRegressionModel(
      image_size=IMAGE, compute_dtype=torch.float32,
      use_avg_model_params=True, avg_model_params_decay=0.9,
      optimizer_fn=optimizers.create_adam_optimizer(
          1e-3, boundaries_and_scales=schedule), **kwargs)


def _batches(n, seed=0):
  """n preprocessed (features, labels) numpy batches of pose_env scenes."""
  images, poses = pose_env.collect_episodes(n * BATCH, seed=seed,
                                            image_size=IMAGE)
  images = images.astype(np.float32) / 255.0
  return [(ts.TensorSpecStruct({"image": images[i * BATCH:(i + 1) * BATCH]}),
           ts.TensorSpecStruct(
               {"target_pose": poses[i * BATCH:(i + 1) * BATCH]}))
          for i in range(n)]


def _tensors(tree):
  return ts.TensorSpecStruct((k, torch.from_numpy(np.ascontiguousarray(v)))
                             for k, v in tree.items())


def _stack(batches):
  return tree_map(lambda *leaves: torch.from_numpy(np.stack(leaves)),
                  *batches)


def _assert_states_equal(got, want):
  assert got.step == want.step
  for name in ("params", "model_state", "ema_params"):
    a, b = getattr(got, name), getattr(want, name)
    assert list(a) == list(b)
    for key in b:
      torch.testing.assert_close(a[key], b[key], rtol=0, atol=0,
                                 msg=f"{name}/{key}")
  got_opt, want_opt = got.opt_state.state_dict(), want.opt_state.state_dict()
  assert got_opt["param_groups"] == want_opt["param_groups"]
  for index, moments in want_opt["state"].items():
    for key, value in moments.items():
      torch.testing.assert_close(got_opt["state"][index][key], value,
                                 rtol=0, atol=0, msg=f"adam {index}/{key}")


class TestTrainSteps:

  @pytest.mark.parametrize("stacks", [(5,), (3, 2)], ids=["full", "partial"])
  def test_equal_to_single_steps_bit_for_bit(self, stacks):
    """K = 5 in one stack, and a stack of 3 then a final one of 2."""
    batches = _batches(sum(stacks))
    model = _model()
    stacked, single = Trainer(model, device="cpu"), Trainer(model,
                                                            device="cpu")
    a, b = stacked.create_train_state(), single.create_train_state()
    start = 0
    for size in stacks:
      a, metrics = stacked.train_steps(
          a, *_stack(batches[start:start + size]))
      start += size
    for features, labels in batches:
      b, want = single.train_step(b, _tensors(features), _tensors(labels))
    _assert_states_equal(a, b)
    assert a.step == sum(stacks)
    for key in want:
      assert float(metrics[key]) == float(want[key])

  def test_schedule_boundary_inside_a_stack(self):
    """The rate halves after step 3 of a 5-step stack, as one step at a
    time; the CUDA graph, which would bake one rate in, refuses it."""
    batches = _batches(5, seed=1)
    model = _model(schedule=[(3, 0.5)])
    stacked, single = Trainer(model, device="cpu"), Trainer(model,
                                                            device="cpu")
    a, b = stacked.create_train_state(), single.create_train_state()
    a, _ = stacked.train_steps(a, *_stack(batches))
    for features, labels in batches:
      b, _ = single.train_step(b, _tensors(features), _tensors(labels))
    _assert_states_equal(a, b)
    assert a.opt_state.param_groups[0]["lr"] == pytest.approx(5e-4)
    assert (a.opt_state.lr_schedule.state_dict()
            == b.opt_state.lr_schedule.state_dict())
    with pytest.raises(NotImplementedError, match="learning-rate schedule"):
      check_graphable(a.opt_state)

  def test_what_the_graph_cannot_hold_raises_by_name(self):
    params = [torch.zeros(2, requires_grad=True)]
    with pytest.raises(NotImplementedError, match="capturable=True"):
      check_graphable(torch.optim.Adam(params, lr=1e-3))
    with pytest.raises(NotImplementedError, match="Adagrad"):
      check_graphable(torch.optim.Adagrad(params))
    for build in (optimizers.create_momentum_optimizer(),
                  optimizers.create_rmsprop_optimizer()):
      check_graphable(build(params))  # state created at the first step
    # On the CPU Adam keeps its step count on the host.
    assert not optimizers.create_adam_optimizer()(params).param_groups[0][
        "capturable"]

  def test_restore_keeps_the_capturable_flag_it_was_built_with(self):
    """A checkpoint of a GPU run holds capturable=True; resumed on the
    CPU, Adam keeps the CPU's flag and steps."""
    params = [torch.zeros(3, requires_grad=True)]
    optimizer = optimizers.create_adam_optimizer()(params)
    params[0].grad = torch.ones(3)
    optimizer.step()
    saved = optimizer.state_dict()
    saved["param_groups"][0]["capturable"] = True
    fresh = optimizers.create_adam_optimizer()(params)
    optimizers.load_state(fresh, saved)
    assert not fresh.param_groups[0]["capturable"]
    fresh.step()
    assert float(fresh.state[params[0]]["step"]) == 2.0

  def test_launch_counts_through_replays(self):
    counts = {"a": 0, "b": 0}

    def add(kernel, n):
      counts[kernel] += n

    graph_launches.count(add, "a")  # no capture on the CPU: counts now
    with graph_launches.recording() as tally:
      tally[(add, "b")] += 3  # as a capture would record three launches
    graph_launches.replayed(tally, times=2)
    assert counts == {"a": 1, "b": 6}

  def test_captures_pause_the_collector_and_restore_it(self):
    """The collector is off while any capture is open (nested ones
    included) and back as it was after the last closes."""
    assert gc.isenabled()
    with graph_launches._collector_paused():
      with graph_launches._collector_paused():
        assert not gc.isenabled()
      assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
      with graph_launches._collector_paused():
        pass
      assert not gc.isenabled()  # a collector the caller turned off stays off
    finally:
      gc.enable()


def _jax_accum(jax_model, batches):
  trainer = JaxTrainer(jax_model, seed=0)
  state = trainer.create_train_state()
  initial = jax.device_get(state.variables())
  features, labels = tree_map(lambda *leaves: np.stack(leaves), *batches)
  state, metrics = trainer.train_step_accum(
      state, jax_ts.TensorSpecStruct(dict(features)),
      jax_ts.TensorSpecStruct(dict(labels)))
  return initial, jax.device_get(state.variables()), metrics


class TestAccumulation:

  def test_matches_the_jax_train_step_accum(self):
    """Three microbatches of 8: the statistics thread through them in
    order, the gradients average before one Adam step."""
    _needs_jax()
    batches = _batches(3, seed=2)
    jax_model = jax_models.PoseEnvRegressionModel(
        image_size=IMAGE, compute_dtype=jax.numpy.float32)
    model = pose_env_models.PoseEnvRegressionModel(
        image_size=IMAGE, compute_dtype=torch.float32)
    initial, want_state, want = _jax_accum(jax_model, batches)
    trainer = Trainer(model, device="cpu")
    state = trainer.create_train_state(initial)
    state, got = trainer.train_step_accum(state, *_stack(batches))
    assert state.step == 1
    assert sorted(got) == sorted(want)
    for key in want:
      assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5)
    got_tree = bridge.state_dict_to_variables(
        {k: v.detach() for k, v in state.variables().items()})
    flat_got = jax_ts.flatten_spec_structure(got_tree)
    flat_want = jax_ts.flatten_spec_structure(want_state)
    assert sorted(flat_got) == sorted(flat_want)
    for key in flat_want:
      scope = ".".join(key.split("/")[1:-1])
      atol = F32_ATOL + (2 * ADAM_STEP if f"{scope}.bias" in BN_FED_BIASES
                         else 0.0)
      np.testing.assert_allclose(np.asarray(flat_got[key]),
                                 np.asarray(flat_want[key]), rtol=0,
                                 atol=atol, err_msg=key)

  def test_one_microbatch_is_one_step(self):
    batches = _batches(1, seed=3)
    model = _model()
    one, accum = Trainer(model, device="cpu"), Trainer(model, device="cpu")
    a, b = one.create_train_state(), accum.create_train_state()
    a, _ = one.train_step(a, *(_tensors(t) for t in batches[0]))
    b, _ = accum.train_step_accum(b, *_stack(batches))
    _assert_states_equal(a, b)


class _ConstantGenerator(AbstractInputGenerator):
  """The same batch every step, so a restarted stream is the same one."""

  def __init__(self, batch):
    super().__init__(batch_size=BATCH)
    self._batch = batch

  def _create_iterator(self, mode):
    features, labels = self._batch
    while True:
      yield (ts.TensorSpecStruct({k: v.copy() for k, v in features.items()}),
             ts.TensorSpecStruct({k: v.copy() for k, v in labels.items()}))


def _uint8_batch():
  images, poses = pose_env.collect_episodes(BATCH, seed=0, image_size=IMAGE)
  return (ts.TensorSpecStruct({"image": images}),
          ts.TensorSpecStruct({"target_pose": poses}))


class TestTrainEval:

  def _run(self, tmp_path, name, steps, **kwargs):
    return train_eval.train_eval_model(
        _model(), input_generator_train=_ConstantGenerator(_uint8_batch()),
        max_train_steps=steps, model_dir=str(tmp_path / name),
        save_checkpoints_steps=50, log_every_steps=50, device="cpu",
        **kwargs)

  def test_iterations_per_loop_to_the_end_with_resume(self, tmp_path):
    first = self._run(tmp_path, "run", 60, iterations_per_loop=50)
    assert first.state.step == 60
    assert first.loop_stats["steps"] == 2  # a stack of 50, then one of 10
    assert first.loop_stats["steps_per_dispatch"] == 50
    resumed = self._run(tmp_path, "run", 120, iterations_per_loop=50)
    plain = self._run(tmp_path, "plain", 120)
    _assert_states_equal(resumed.state, plain.state)
    run = tmp_path / "run"
    assert sorted(int(s) for s in os.listdir(run / "checkpoints")) == [
        50, 60, 110, 120]
    assert [json.loads(line)["step"]
            for line in open(run / "metrics.jsonl")] == [50, 60, 110, 120]

  def test_gradient_accumulation_to_the_end_with_resume(self, tmp_path):
    self._run(tmp_path, "run", 3, gradient_accumulation_steps=4)
    resumed = self._run(tmp_path, "run", 6, gradient_accumulation_steps=4)
    assert resumed.state.step == 6
    trainer = Trainer(_model(), device="cpu")
    state = trainer.create_train_state()
    features, labels = _model().preprocessor.preprocess(
        *_uint8_batch(), "train")
    for _ in range(6):
      state, _ = trainer.train_step_accum(
          state, *_stack([(features, labels)] * 4))
    _assert_states_equal(resumed.state, state)

  @pytest.mark.parametrize("kwargs, match", [
      (dict(iterations_per_loop=2, gradient_accumulation_steps=2),
       "mutually exclusive"),
      (dict(iterations_per_loop=0), "iterations_per_loop must be >= 1"),
      (dict(gradient_accumulation_steps=0),
       "gradient_accumulation_steps must be >= 1")])
  def test_invalid_combinations_raise(self, kwargs, match):
    with pytest.raises(ValueError, match=match):
      train_eval.train_eval_model(_model(), max_train_steps=0, device="cpu",
                                  **kwargs)

  def test_what_still_waits_names_its_item(self):
    # Nothing of the JAX loop waits any more: the parallel tier's
    # arguments came with item 15a (tests/test_torch_parallel_train.py).
    assert not hasattr(train_eval, "_WAITING")
    for name in ("iterations_per_loop", "gradient_accumulation_steps",
                 "mesh", "param_specs", "shard_optimizer_state", "fsdp",
                 "fsdp_min_size"):
      assert name in inspect.signature(
          train_eval.train_eval_model).parameters

  def test_stack_batches_sizes(self):
    stream = iter(_batches(1) * 7)
    sizes = [int(f["image"].shape[0]) for f, _ in
             train_eval._stack_batches(stream, 3, 7)]
    assert sizes == [3, 3, 1]


class TestCLIs:

  def test_capability_check_qtopt_on_the_cpu(self, monkeypatch, capsys,
                                             tmp_path):
    """The qtopt check at a miniature size through main: the record
    path, train_eval_model with iterations_per_loop (a partial stack),
    the native export, CEM over the predictor's device_fn, 200 scenes."""
    monkeypatch.setitem(run_capability_checks._SCALES["qtopt"], "fast",
                        dict(grasps=48, steps=6, image=16))
    monkeypatch.setattr(run_capability_checks, "ITERATIONS_PER_LOOP", 4)
    monkeypatch.setitem(run_capability_checks._EXPECT, ("qtopt", "fast"),
                        0.0)
    assert run_capability_checks.main([
        "--checks", "qtopt", "--device", "cpu", "--workdir",
        str(tmp_path)]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["check"] == "qtopt" and record["passed"] is True
    assert 0.0 <= record["success_rate"] <= 1.0
    assert 0.0 <= record["random_success_rate"] <= 1.0
    assert record["steps_per_dispatch"] == 4
    monkeypatch.setitem(run_capability_checks._EXPECT, ("qtopt", "fast"),
                        1.01)
    assert run_capability_checks.main([
        "--checks", "qtopt", "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out)["passed"] is False

  def test_qtopt_cfg_trains_and_writes_the_jax_operative_config(
      self, tmp_path):
    """The port's qtopt_train.cfg through its CLI with a miniature
    binding: a few momentum-SGD steps on the CPU, and the same
    operative_config.txt the JAX CLI writes for the same file."""
    _needs_jax()
    records = str(tmp_path / "grasps.tfrecord")
    synthetic_grasping.write_tfrecords(records, 16, image_size=16, seed=0)
    args = ["--binding",
            f'DefaultRecordInputGenerator.file_patterns = "{records}"',
            "--binding", "DefaultRecordInputGenerator.batch_size = 8",
            "--binding", "QTOptGraspingModel.image_size = 16",
            "--binding", "train_eval_model.max_train_steps = 3",
            "--binding", "train_eval_model.save_checkpoints_steps = 2",
            "--model_dir", str(tmp_path / "run")]
    assert jax_cli.main(["--config", JAX_QTOPT_CFG, "--import_module",
                         "tensor2robot_tpu.research.qtopt.t2r_models"]
                        + args) == 0
    want = (tmp_path / "run" / "operative_config.txt").read_text()
    os.rename(tmp_path / "run", tmp_path / "jax_run")
    jax_config.clear_config()
    assert run_t2r_trainer.main(
        ["--config", PORT_QTOPT_CFG, "--import_module",
         "tensor2robot_tpu_torch.research.qtopt.t2r_models",
         "--device", "cpu"] + args) == 0
    run = tmp_path / "run"
    assert (run / "operative_config.txt").read_text() == want
    assert "create_momentum_optimizer.momentum = 0.9" in want
    assert sorted(os.listdir(run / "checkpoints")) == ["2", "3"]
    payload = torch.load(str(run / "checkpoints" / "3" / "state.pt"),
                         weights_only=True)
    assert payload["optimizer"]["param_groups"][0]["momentum"] == 0.9
    assert os.listdir(run / "export" / "latest")


def _to(trees, device):
  return tuple(ts.TensorSpecStruct((k, v.to(device)) for k, v in t.items())
               for t in trees)


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [5, 3])
def test_cuda_graph_equals_eager_steps(cuda_device, steps):
  """A warm-up stack (eager, on the trainer's side stream), then a
  `steps` stack as one CUDA graph, against the same steps eagerly: the
  states agree bit for bit (cuDNN deterministic), and K1's launches count
  once a step through the replay."""
  ss = importlib.import_module(
      "tensor2robot_tpu_torch.ops.spatial_softmax").spatial_softmax
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    model = pose_env_models.PoseEnvRegressionModel(
        image_size=IMAGE, use_avg_model_params=True,
        optimizer_fn=optimizers.create_adam_optimizer(1e-3))
    batches = _batches(2 + steps, seed=4)
    warm = [_to(_stack(batches[:2]), cuda_device)]
    stack = _to(_stack(batches[2:]), cuda_device)
    states = []
    for graphed in (True, False):
      trainer = Trainer(model, device=cuda_device)
      state = trainer.create_train_state()
      if graphed:
        state, _ = trainer.train_steps(state, *warm[0])
        before = ss.launches
        state, metrics = trainer.train_steps(state, *stack)
        torch.cuda.synchronize()
        assert ss.launches - before == steps
      else:
        for i in range(2 + steps):
          source = warm[0] if i < 2 else stack
          j = i if i < 2 else i - 2
          state, metrics = trainer.train_step(
              state, *(ts.TensorSpecStruct((k, v[j]) for k, v in t.items())
                       for t in source))
      states.append((state, float(metrics["loss"])))
    (a, loss_a), (b, loss_b) = states
    assert loss_a == loss_b
    for name in ("params", "model_state", "ema_params"):
      for key, value in getattr(b, name).items():
        torch.testing.assert_close(getattr(a, name)[key], value, rtol=0,
                                   atol=0)
  finally:
    torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
def test_cuda_capture_survives_a_collection(cuda_device):
  """An unreachable graph of an earlier capture, held in a reference
  cycle, is garbage when a later capture allocates enough to trigger the
  collector; destroying it mid-capture would invalidate that capture."""

  class Cycle:
    pass

  def graph_in_a_cycle():
    graph, x = torch.cuda.CUDAGraph(), torch.zeros(8, device=cuda_device)
    with graph_launches.capture(graph, torch.cuda.Stream(cuda_device)):
      y = x + 1
    cycle = Cycle()
    cycle.me, cycle.graph, cycle.tensors = cycle, graph, (x, y)
    return cycle

  graph = torch.cuda.CUDAGraph()
  x = torch.arange(8.0, device=cuda_device)
  cycle = graph_in_a_cycle()
  with graph_launches.capture(graph, torch.cuda.Stream(cuda_device)):
    del cycle  # now only the collector can free the earlier graph
    junk = [[i] for i in range(200_000)]  # many collector thresholds' worth
    y = x * 2
  del junk
  graph.replay()
  torch.testing.assert_close(y, torch.arange(8.0, device=cuda_device) * 2)


@pytest.mark.cuda
def test_cuda_graph_refuses_a_schedule(cuda_device):
  model = _model(schedule=[(2, 0.5)])
  trainer = Trainer(model, device=cuda_device)
  state = trainer.create_train_state()
  stack = _to(_stack(_batches(2)), cuda_device)
  with pytest.raises(NotImplementedError, match="learning-rate schedule"):
    trainer.train_steps(state, *stack)
