"""Registers the port's standard components as configurables.

Imported by the CLI (and anyone using config files) so `@Name` references
resolve without per-module imports. Counterpart of
``tensor2robot_tpu/config/registrations.py`` for what the port has: the
input generators and the native export generator. The optimizer
factories, ``train_eval_model`` and the research models register where
they are defined.
"""

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.data.default_input_generator import (
    DefaultRandomInputGenerator,
    DefaultRecordInputGenerator,
    FractionalRecordInputGenerator,
    WeightedRecordInputGenerator,
)
from tensor2robot_tpu_torch.export.native_export_generator import (
    NativeExportGenerator,
)
from tensor2robot_tpu_torch.utils import optimizers  # noqa: F401 (registers)

for _cls in (
    DefaultRandomInputGenerator,
    DefaultRecordInputGenerator,
    FractionalRecordInputGenerator,
    WeightedRecordInputGenerator,
    NativeExportGenerator,
):
  configurable(_cls)
