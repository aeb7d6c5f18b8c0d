"""QT-Opt grasping: the BASELINE north-star workload."""

from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
    QTOptGraspingModel,
)

__all__ = ["QTOptGraspingModel", "cem"]
