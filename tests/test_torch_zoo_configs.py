"""The zoo's configs and capability checks in the port.

The three configs (``grasp2vec_train.cfg``, ``vrgripper_train.cfg``,
``vrgripper_tec_train.cfg``) through the JAX CLI and the port's, at 0
steps and small bindings: the same ``operative_config.txt``, and an
export. ``check_grasp2vec`` and ``check_vrgripper`` through the port's
capability CLI at a miniature size, with the JAX scales and bars kept.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has none
  import jax
  from tensor2robot_tpu import config as jax_config
  from tensor2robot_tpu.bin import run_t2r_trainer as jax_cli
except ImportError:
  jax = None

from tensor2robot_tpu_torch import config  # noqa: E402
from tensor2robot_tpu_torch.bin import (  # noqa: E402
    run_capability_checks,
    run_t2r_trainer,
)
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    episode_to_transitions,
)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (research family, config file, model module, small bindings)
CFGS = {
    "grasp2vec": ("grasp2vec", "grasp2vec_train.cfg", "grasp2vec_model",
                  ["Grasp2VecModel.depth = 18", "Grasp2VecModel.width = 4",
                   "Grasp2VecModel.image_size = 32"]),
    "vrgripper": ("vrgripper", "vrgripper_train.cfg", "vrgripper_env_models",
                  ["VRGripperEnvModel.image_size = 16"]),
    "vrgripper_tec": ("vrgripper", "vrgripper_tec_train.cfg",
                      "vrgripper_env_tec_models",
                      ["VRGripperEnvTecModel.image_size = 16",
                       "DefaultRandomInputGenerator.batch_size = 2"]),
}


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


def _episode(seed, steps, size=16):
  rng = np.random.default_rng(seed)
  return {"images": rng.integers(0, 256, (steps, size, size, 3), np.uint8),
          "gripper_poses": rng.normal(size=(steps, 14)).astype(np.float32),
          "actions": rng.normal(size=(steps, 7)).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_cfg_through_both_clis_writes_one_operative_config(name, tmp_path):
  """Each config through the JAX CLI and the port's at 0 steps (the run
  builds the model and its generators, writes the operative config and
  exports): the same operative_config.txt."""
  if jax is None:
    pytest.skip("needs JAX, the reference")
  family, cfg, module, bindings = CFGS[name]
  records = str(tmp_path / "train.tfrecord")
  episode_to_transitions.write_episodes(records, [_episode(0, 2)])
  args = []
  for binding in bindings + [
      f'DefaultRecordInputGenerator.file_patterns = "{records}"',
      "DefaultRecordInputGenerator.batch_size = 2",
      "train_eval_model.max_train_steps = 0"]:
    args += ["--binding", binding]
  args += ["--model_dir", str(tmp_path / "run")]
  assert jax_cli.main(
      ["--config", os.path.join(_REPO_ROOT, "tensor2robot_tpu", "research",
                                family, "configs", cfg),
       "--import_module", f"tensor2robot_tpu.research.{family}.{module}"]
      + args) == 0
  want = (tmp_path / "run" / "operative_config.txt").read_text()
  os.rename(tmp_path / "run", tmp_path / "jax_run")
  assert run_t2r_trainer.main(
      ["--config", os.path.join(_REPO_ROOT, "tensor2robot_tpu_torch",
                                "research", family, "configs", cfg),
       "--import_module",
       f"tensor2robot_tpu_torch.research.{family}.{module}",
       "--device", "cpu"] + args) == 0
  assert (tmp_path / "run" / "operative_config.txt").read_text() == want
  assert os.listdir(tmp_path / "run" / "export" / "latest")


@pytest.mark.parametrize("check, knobs", [
    ("grasp2vec", dict(triplets=96, steps=4, image=16)),
    ("vrgripper", dict(demos=96, steps=4, image=16)),
])
def test_check_in_miniature(check, knobs, monkeypatch, capsys, tmp_path):
  """The check through main at a miniature size (stacks of 2 steps): its
  record, the bar passed at 0 and missed above 1."""
  monkeypatch.setitem(run_capability_checks._SCALES[check], "fast", knobs)
  monkeypatch.setattr(run_capability_checks, "ZOO_ITERATIONS_PER_LOOP", 2)
  monkeypatch.setitem(run_capability_checks._EXPECT, (check, "fast"), 0.0)
  assert run_capability_checks.main([
      "--checks", check, "--device", "cpu", "--workdir",
      str(tmp_path)]) == 0
  record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert record["check"] == check and record["passed"] is True
  assert 0.0 <= record["success_rate"] <= 1.0
  assert record["steps_per_dispatch"] == 2
  monkeypatch.setitem(run_capability_checks._EXPECT, (check, "fast"), 1.01)
  assert run_capability_checks.main([
      "--checks", check, "--device", "cpu", "--workdir",
      str(tmp_path)]) == 1
  assert json.loads(capsys.readouterr().out)["passed"] is False


def test_checks_keep_the_jax_scales_and_bars():
  expect, scales = run_capability_checks._EXPECT, run_capability_checks._SCALES
  assert expect[("grasp2vec", "fast")] == 0.38
  assert expect[("grasp2vec", "full")] == 0.62
  assert expect[("vrgripper", "fast")] == 0.65
  assert expect[("vrgripper", "full")] == 0.80
  assert scales["grasp2vec"]["fast"] == dict(triplets=2048, steps=600,
                                             image=64)
  assert scales["vrgripper"]["fast"] == dict(demos=2000, steps=800, image=64)
