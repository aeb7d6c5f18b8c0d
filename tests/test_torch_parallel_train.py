"""Training over a mesh of ranks (data parallel, ZeRO-1, FSDP, tensor
parallel) held against the JAX package and against one rank's run.

The QT-Opt critic (64x64, float32, BatchNorm, the EMA kept) starts from
the JAX init in both packages (the port warm-starts from its npz) and
trains 3 Adam steps on DefaultRandomInputGenerator's batches, which both
packages draw alike. JAX trains data parallel over {"data": 2} of the 8
virtual CPU devices; the port trains each mode in 2 CPU gloo ranks
(``tests/torch_parallel_ranks.py``) through ``train_eval_model``.

Tolerances: losses within 1e-4 relative (the JAX TP test's bar); running
statistics within 1e-4; against one rank's run, each tensor's first
gradient within 1e-3 of its largest and its Adam update within 1e-6
where the gradient is above that share (``chip_smoke.compare_training``,
which the card's run uses too; Adam's first update is blind to a
gradient's scale, so the gradients are held too).
"""

import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has no flax
  import jax
  from tensor2robot_tpu.data import default_input_generator as jax_data
  from tensor2robot_tpu.parallel import mesh as jax_mesh
  from tensor2robot_tpu.research.qtopt import t2r_models as jax_qtopt
  from tensor2robot_tpu.train import train_eval as jax_train_eval
  from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
except ImportError:
  jax = None

import torch_parallel_ranks as ranks  # noqa: E402
from tensor2robot_tpu_torch.export import variables_io  # noqa: E402
import chip_smoke as smoke  # noqa: E402
from tensor2robot_tpu_torch.parallel import launch  # noqa: E402
from tensor2robot_tpu_torch.train import train_eval  # noqa: E402
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402
from tensor2robot_tpu_torch.utils import optimizers  # noqa: E402
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = list(smoke.PARALLEL_MODES)
STEPS, BATCH, SEED = 3, 8, 0
TOLERANCES = dict(loss_rtol=1e-4, stats_atol=1e-4, adam_atol=1e-6,
                  grad_share=1e-3, grad_noise_share=1e-3)


@pytest.fixture(autouse=True)
def _needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


def _cli(model_dir: str):
  """run_t2r_trainer under torch.distributed.run: 2 CPU ranks, the mock
  with fsdp=True."""
  bindings = [
      "train_eval_model.model = @MockT2RModel()",
      "MockT2RModel.hidden_size = 128",
      "train_eval_model.input_generator_train = "
      "@DefaultRandomInputGenerator()",
      "DefaultRandomInputGenerator.batch_size = 8",
      "train_eval_model.max_train_steps = 2",
      "train_eval_model.log_every_steps = 1",
      "train_eval_model.fsdp = True",
      "train_eval_model.fsdp_min_size = 128",
  ]
  args = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
          "--nproc-per-node", "2", "--master-addr", "localhost",
          "--master-port", str(_free_port()), "-m",
          "tensor2robot_tpu_torch.bin.run_t2r_trainer", "--device", "cpu",
          "--model_dir", model_dir]
  for binding in bindings:
    args += ["--binding", binding]
  env = {**os.environ, "PYTHONPATH": _REPO, "OMP_NUM_THREADS": "1"}
  return subprocess.Popen(args, cwd=_REPO, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)


def _jax_run(model_dir: str, npz: str) -> dict:
  """JAX's data-parallel run on {"data": 2}: each step's loss (its metric
  file) and the final running statistics; the init goes to `npz`."""
  model = jax_qtopt.QTOptGraspingModel(
      image_size=64, compute_dtype=np.float32, use_avg_model_params=True)
  mesh = jax_mesh.create_mesh({"data": 2}, devices=jax.devices()[:2])
  init = JaxTrainer(model, mesh=mesh, seed=SEED).create_train_state()
  variables_io.save_variables(npz, jax.tree_util.tree_map(
      np.asarray, init.variables()))
  result = jax_train_eval.train_eval_model(
      model, input_generator_train=jax_data.DefaultRandomInputGenerator(
          batch_size=BATCH, seed=SEED),
      max_train_steps=STEPS, model_dir=model_dir, log_every_steps=1,
      mesh=mesh, seed=SEED, handle_preemption=False)
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    losses = [json.loads(line)["loss"] for line in f]
  stats = jax.tree_util.tree_map(np.asarray,
                                 result.state.model_state["batch_stats"])
  return {"losses": losses, "batch_stats": stats}


@pytest.fixture(scope="module")
def runs():
  """The JAX run, then, at once: the port's modes in 2 ranks, the mock's
  compositions in 4, and the CLI under torch.distributed.run."""
  if jax is None:
    pytest.skip("needs JAX, the reference")
  with tempfile.TemporaryDirectory() as root:
    npz = os.path.join(root, "init", "variables.npz")
    os.makedirs(os.path.dirname(npz))
    jax_result = _jax_run(os.path.join(root, "jax"), npz)
    cfg = dict(device="cpu", image_size=64, batch=BATCH, seed=SEED,
               steps=STEPS, modes=MODES, model_dir=os.path.join(root, "port"),
               init_from_checkpoint=npz)
    rng = np.random.default_rng(3)
    mock_cfg = {"modes": ["tp_zero1", "fsdp4"], "steps": 3,
                "x": rng.standard_normal((8, 3)).astype(np.float32),
                "target": rng.standard_normal((8, 1)).astype(np.float32),
                "variables": None}
    mock = MockT2RModel(hidden_size=128, compute_dtype=torch.float32)
    mock_cfg["variables"] = {k: v.numpy() for k, v in mock.init_variables(
        torch.Generator().manual_seed(7), device="cpu").items()}
    cli_dir = os.path.join(root, "cli")
    cli = _cli(cli_dir)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
      modes = pool.submit(launch.launch, ranks.train_modes, 2, (cfg,),
                          timeout_s=600)
      composed = pool.submit(launch.launch, ranks.mock_composition, 4,
                             (mock_cfg,), timeout_s=600)
      reference = smoke.train_reference({**cfg, "model_dir": os.path.join(
          root, "one")})
      modes, composed = modes.result(), composed.result()
    evaluated = launch.launch(ranks.continuous_eval, 2, (cfg,),
                              timeout_s=300)
    alone = train_eval.continuous_eval_model(
        smoke.parallel_flagship_model(cfg), ranks_generator(cfg),
        os.path.join(cfg["model_dir"], "dp"), eval_steps=2,
        poll_interval_s=0.05, timeout_s=1.0, stop_after_step=STEPS,
        device="cpu")
    cli_output, _ = cli.communicate(timeout=300)
    with open(os.path.join(cfg["model_dir"], "dp", "metrics.jsonl")) as f:
      metric_lines = [json.loads(line) for line in f]
    cli_files = {
        "rc": cli.returncode, "output": cli_output[-3000:],
        "metrics": open(os.path.join(cli_dir, "metrics.jsonl")).read()
        if os.path.exists(os.path.join(cli_dir, "metrics.jsonl")) else "",
        "checkpoints": sorted(os.listdir(os.path.join(cli_dir,
                                                      "checkpoints")))
        if os.path.isdir(os.path.join(cli_dir, "checkpoints")) else []}
    files = {"operative_config": os.path.exists(os.path.join(
        cfg["model_dir"], "dp", "operative_config.txt"))}
  return {"jax": jax_result, "reference": reference, "modes": modes,
          "composed": composed, "mock_cfg": mock_cfg,
          "evaluated": evaluated, "alone": alone, "cfg": cfg,
          "metric_lines": metric_lines, "cli": cli_files, "files": files}


def ranks_generator(cfg):
  from tensor2robot_tpu_torch.data.default_input_generator import (
      DefaultRandomInputGenerator,
  )
  return DefaultRandomInputGenerator(batch_size=cfg["batch"],
                                     seed=cfg["seed"] + 1)


def test_one_rank_run_matches_jax(runs):
  np.testing.assert_allclose(runs["reference"]["losses"],
                             runs["jax"]["losses"], rtol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_mode_losses_match_jax_data_parallel(runs, mode):
  np.testing.assert_allclose(runs["modes"][0][mode]["losses"],
                             runs["jax"]["losses"], rtol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_batch_norm_statistics_match_jax_mesh_run(runs, mode):
  """Under a data mesh BatchNorm takes the global batch's moments, as XLA
  reduces them over the sharded batch: the running statistics equal the
  JAX mesh run's and the one-rank run's."""
  got = runs["modes"][0][mode]["batch_stats"]
  for scope, stats in runs["jax"]["batch_stats"].items():
    for name, value in (("running_mean", stats["mean"]),
                        ("running_var", stats["var"])):
      np.testing.assert_allclose(got[f"{scope}.{name}"], value, atol=1e-4)
  for key, value in runs["reference"]["batch_stats"].items():
    np.testing.assert_allclose(got[key], value, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_one_rank_run(runs, mode):
  report = smoke.compare_training(runs["reference"], runs["modes"][0][mode],
                                  smoke.parallel_flagship_model(runs["cfg"]),
                                  TOLERANCES)
  assert report["update_held_share"] > 0.5


@pytest.mark.parametrize("mode", MODES)
def test_parameters_really_sharded(runs, mode):
  got = runs["modes"][0][mode]
  whole = got["checkpoint_params_whole"]
  local, opt = got["local_shapes"], got["opt_local_shapes"]
  if mode == "dp":
    assert local == whole and opt == whole
  elif mode == "zero1":
    assert local == whole
    assert opt["pre_conv0.weight"] == [64, 32, 3, 3]  # flax I split
    assert opt["q_head.bias"] == [1]
  elif mode == "fsdp":
    assert local["pre_conv0.weight"] == [64, 32, 3, 3]
    assert local["stem_bn.weight"] == [64]  # below fsdp_min_size
    assert opt == local
  else:  # the critic's partition rules on {"data": 1, "model": 2}
    assert local["stem.weight"] == [32, 3, 6, 6]
    assert local["stem_bn.weight"] == [32]
    assert local["fc1.weight"] == [32, 64]
    assert local["q_head.weight"] == [1, 64]
    assert opt == local  # TP alone: the moments mirror the parameters
    assert got["layout"]["column_parallel_modules"] == [
        "action_fc1", "action_fc2", "fc1", "post_conv0", "post_conv1",
        "post_conv2", "pre_conv0", "pre_conv1", "pre_conv2", "stem"]
  # The moments the optimizer holds add up to the layout's table.
  assert got["moment_elements_local"] == (
      got["layout"]["optimizer_elements_local"])
  assert (got["moment_elements_local"] == got["layout"][
      "param_elements_whole"]) == (mode == "dp")
  assert got["graphed"] is False
  assert got["checkpoint_mesh"] == got["layout"]["mesh"]


def test_checkpoint_restores_onto_its_geometry_only(runs):
  results = runs["modes"]
  for rank in results:
    assert "resume mesh geometry mismatch" in rank["refusal"]
    assert rank["restored_step"] == STEPS
  # The data-parallel run's final state, restored whole through ZeRO-1's
  # blocks on the same geometry.
  final = runs["modes"][0]["dp"]
  for key, value in results[0]["restored"].items():
    if key in final["batch_stats"]:
      np.testing.assert_array_equal(value, final["batch_stats"][key])


def test_primary_only_writes(runs):
  """One metric line a step (not one a rank), one operative config; the
  primary is rank 0."""
  assert [line["step"] for line in runs["metric_lines"]] == [1, 2, 3]
  assert runs["files"]["operative_config"]
  assert [r["is_primary"] for r in runs["modes"]] == [True, False]


def test_continuous_eval_over_a_mesh(runs):
  got = runs["evaluated"]
  assert list(got[0]) == [STEPS] == list(runs["alone"])
  assert got[0] == got[1]
  for key, value in runs["alone"][STEPS].items():
    np.testing.assert_allclose(got[0][STEPS][key], value, rtol=1e-5)


def _one_rank_mock(cfg):
  model = MockT2RModel(hidden_size=128, compute_dtype=torch.float32,
                       optimizer_fn=optimizers.create_adam_optimizer(1e-2))
  trainer = Trainer(model, seed=5, device="cpu")
  state = trainer.create_train_state(
      {k: torch.from_numpy(v) for k, v in cfg["variables"].items()})
  features = {"x": torch.from_numpy(cfg["x"])}
  labels = {"target": torch.from_numpy(cfg["target"])}
  losses, norms = [], []
  for _ in range(cfg["steps"]):
    state, metrics = trainer.train_step(state, features, labels,
                                        with_health=True)
    losses.append(float(metrics["loss"]))
    norms.append(float(metrics["grad_norm"]))
  return losses, norms, {k: float(v) for k, v in trainer.eval_step(
      state, features, labels).items()}


@pytest.mark.parametrize("name", ["tp_zero1", "fsdp4"])
def test_mock_compositions_match_one_rank(runs, name):
  """Tensor parallelism by shape with ZeRO-1 on {"data": 2, "model": 2},
  and FSDP on {"data": 4}: the mock's dropout draws the global batch's
  masks, so every loss, gradient norm and eval metric is the one-rank
  run's."""
  losses, norms, evaluated = _one_rank_mock(runs["mock_cfg"])
  for rank in runs["composed"]:
    got = rank[name]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=1e-5)
    for key, value in evaluated.items():
      np.testing.assert_allclose(got["eval"][key], value, rtol=1e-5)
  local = runs["composed"][0][name]["local"]
  if name == "tp_zero1":
    assert local["Dense_0.weight"] == [64, 3]
    assert local["Dense_0.bias"] == [128]
    assert runs["composed"][0][name]["opt_local"]["Dense_1.weight"] == [
        1, 64]
  else:
    assert local["Dense_0.weight"] == [32, 3]


def test_cli_under_torch_distributed_run(runs):
  cli = runs["cli"]
  assert cli["rc"] == 0, cli["output"]
  assert [json.loads(line)["step"] for line in
          cli["metrics"].splitlines()] == [1, 2]
  assert cli["checkpoints"] == ["2"]


@pytest.mark.parametrize("kwargs, match", [
    ({"param_specs": {}}, "param_specs"),
    ({"shard_optimizer_state": True}, "ZeRO-3 subsumes ZeRO-1")])
def test_fsdp_flag_refusals_as_jax(kwargs, match):
  with pytest.raises(ValueError, match=match):
    train_eval.train_eval_model(MockT2RModel(), fsdp=True,
                                max_train_steps=0, device="cpu", **kwargs)
