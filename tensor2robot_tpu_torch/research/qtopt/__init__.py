"""QT-Opt grasping: the BASELINE north-star workload."""

from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.research.qtopt.device_grasping import (
    DeviceGraspEnv,
    DeviceGraspState,
    SceneBank,
    make_scene_bank,
)
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
    QTOptGraspingModel,
)

__all__ = ["DeviceGraspEnv", "DeviceGraspState", "QTOptGraspingModel",
           "SceneBank", "cem", "make_scene_bank"]
