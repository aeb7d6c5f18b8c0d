"""Native export: the variables and the spec assets, without a program.

Counterpart of the variables-and-assets half of
``tensor2robot_tpu/export/native_export_generator.py``. One version
directory holds:

    variables.npz     the variables as a flax tree (``bridge``), written by
                      ``export/variables_io.py``: the JAX package's
                      ``variables_io`` reads it, and its model can serve it
    t2r_assets.json   feature specs, feature key order and metadata

The JAX export also serialises the PREDICT computation as StableHLO
(``serving_fn.bin``), which only JAX runs. This one writes no program: a
predictor rebuilds the network from the model's code
(``predictors/exported_model_predictor.py``). Its assets say so with
``"format": "variables_npz"``.
"""

from __future__ import annotations

import os

from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.export import export_utils, variables_io
from tensor2robot_tpu_torch.export.abstract_export_generator import (
    AbstractExportGenerator,
)
from tensor2robot_tpu_torch.models.abstract_model import Variables

EXPORT_FORMAT = "variables_npz"


class NativeExportGenerator(AbstractExportGenerator):
  """Writes variables.npz and t2r_assets.json per version."""

  def export(self, variables: Variables, global_step: int = 0) -> str:
    feature_spec = self.feature_spec
    tmp_dir, final_dir = export_utils.versioned_export_dir(self.export_root)
    os.makedirs(tmp_dir)
    variables_io.save_variables(
        os.path.join(tmp_dir, export_utils.VARIABLES_NPZ),
        bridge.state_dict_to_variables(variables))
    export_utils.write_spec_assets(
        tmp_dir, feature_spec,
        extra={"format": EXPORT_FORMAT,
               "feature_keys": list(feature_spec.keys())},
        global_step=global_step)
    return export_utils.publish(tmp_dir, final_dir)
