"""VRGripper: VR-teleop behavior cloning (BASELINE #5)."""

from tensor2robot_tpu_torch.research.vrgripper import episode_to_transitions
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models import (
    VRGripperEnvModel,
    VRGripperRegressionModel,
    vrgripper_maml_model,
)

__all__ = [
    "VRGripperRegressionModel",
    "VRGripperEnvModel",
    "vrgripper_maml_model",
    "episode_to_transitions",
]
