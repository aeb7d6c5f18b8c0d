"""Registers the port's standard components as configurables.

Imported by the CLI (and anyone using config files) so `@Name` references
resolve without per-module imports. Counterpart of
``tensor2robot_tpu/config/registrations.py`` for what the port has: the
input generators, the native export generator, the async export hook's
and the profiler's builders and the mock model. The optimizer factories,
the exporters, the schedules, ``train_eval_model``,
``continuous_eval_model`` and the research models register where they
are defined.
"""

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.data.default_input_generator import (
    DefaultRandomInputGenerator,
    DefaultRecordInputGenerator,
    FractionalRecordInputGenerator,
    WeightedRecordInputGenerator,
)
from tensor2robot_tpu_torch.export import exporters  # noqa: F401 (registers
# LatestExporter, BestExporter, create_default_exporters_fn)
from tensor2robot_tpu_torch.export.native_export_generator import (
    NativeExportGenerator,
)
from tensor2robot_tpu_torch.hooks.async_export_hook import (
    AsyncExportHookBuilder,
)
from tensor2robot_tpu_torch.utils import global_step_functions  # noqa: F401
from tensor2robot_tpu_torch.utils import optimizers  # noqa: F401 (registers)
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel
from tensor2robot_tpu_torch.utils.profiling import ProfilerHookBuilder

for _cls in (
    DefaultRandomInputGenerator,
    DefaultRecordInputGenerator,
    FractionalRecordInputGenerator,
    WeightedRecordInputGenerator,
    NativeExportGenerator,
    AsyncExportHookBuilder,
    MockT2RModel,
    ProfilerHookBuilder,
):
  configurable(_cls)
