"""pose_env: the minimal end-to-end reaching task."""

from tensor2robot_tpu_torch.research.pose_env.eval_policy import (
    evaluate_policy,
    oracle_policy,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env import (
    PoseEnv,
    PoseToyEnv,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
    PoseEnvRegressionModel,
)

__all__ = ["PoseEnv", "PoseToyEnv", "PoseEnvRegressionModel",
           "evaluate_policy", "oracle_policy"]
