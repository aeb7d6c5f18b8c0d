"""Native export: a ``torch.export`` program, the variables, the spec assets.

Counterpart of ``tensor2robot_tpu/export/native_export_generator.py``. One
version directory holds:

    serving_fn.pt2    ``torch.export.save`` of the PREDICT computation,
                      serve(variables, *features_in_key_order) -> {name: out},
                      with a dynamic batch dimension: a robot-side process
                      serves it with no model code
                      (``predictors/exported_model_predictor.py``)
    variables.npz     the variables as a flax tree (``bridge``), written by
                      ``export/variables_io.py``: the JAX package's
                      ``variables_io`` reads it, and its model can serve it
    t2r_assets.json   feature specs, feature key order, the program's
                      variable keys, shapes and dtypes, metadata
    t2r_assets.pb     the proto twin of the JSON assets (proto/t2r.proto)

As the JAX program, this one takes the variables as inputs, so a hot swap
(``set_variables``) needs no new export. It is traced on the CPU with
zero features of batch 2, under ``ops/dispatch.custom_ops``: a hand kernel
on the path is held in the program as its custom op, and the predictor
moves the program to the device it serves on. A program is tied to the
torch version that saved it (the assets record it), so a machine serves
the programs it exported.

A model whose PREDICT forward ``torch.export`` cannot trace with a
dynamic batch (``AbstractT2RModel.exports_program`` False: MAML runs its
tasks in a Python loop) gets no program; the assets' ``format`` says
which artifact a version holds.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import bridge, modes
from tensor2robot_tpu_torch.export import export_utils, variables_io
from tensor2robot_tpu_torch.export.abstract_export_generator import (
    AbstractExportGenerator,
)
from tensor2robot_tpu_torch.models.abstract_model import Variables
from tensor2robot_tpu_torch.ops import dispatch
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

PROGRAM_FORMAT = "torch_export_pt2"
EXPORT_FORMAT = "variables_npz"  # a version without a program
SERVING_FN_NAME = "serving_fn.pt2"
_TRACE_BATCH = 2  # torch.export specialises a dimension traced at 0 or 1


class _Serve(nn.Module):
  """serve(variables, *features) -> {name: output}, PREDICT mode."""

  def __init__(self, model, keys: List[str]):
    super().__init__()
    self._model = model
    self._keys = keys

  def forward(self, variables: Dict[str, torch.Tensor], *features):
    outputs, _ = self._model.inference_network_fn(
        variables, ts.TensorSpecStruct(zip(self._keys, features)),
        modes.PREDICT)
    return export_utils.normalize_serving_outputs(outputs)


def export_program(model, feature_spec: ts.TensorSpecStruct,
                   variables: Variables) -> torch.export.ExportedProgram:
  """`model`'s PREDICT forward as a program over (variables, *features in
  `feature_spec`'s order), the batch dimension dynamic."""
  keys = list(feature_spec.keys())
  model.thread_module()  # built before the trace, which cannot build it
  batch = torch.export.Dim("batch", min=1)
  features = tuple(
      torch.from_numpy(np.zeros((_TRACE_BATCH,) + spec.shape, spec.dtype))
      for spec in feature_spec.values())
  variables = {key: value.detach().cpu() for key, value in variables.items()}
  # *features are one positional group for the dynamic-shape spec.
  dynamic = ({key: None for key in variables},
             tuple({0: batch} for _ in keys))
  with dispatch.custom_ops(), torch.no_grad():
    return torch.export.export(_Serve(model, keys), (variables,) + features,
                               dynamic_shapes=dynamic, strict=False)


class NativeExportGenerator(AbstractExportGenerator):
  """Writes serving_fn.pt2, variables.npz and the spec assets per
  version."""

  def __init__(self, export_root: Optional[str] = None):
    super().__init__(export_root)
    self.last_trace_s: Optional[float] = None  # the last export's trace

  def export(self, variables: Variables, global_step: int = 0) -> str:
    feature_spec = self.feature_spec
    model = self._model
    tmp_dir, final_dir = export_utils.versioned_export_dir(self.export_root)
    os.makedirs(tmp_dir)
    extra = {"format": EXPORT_FORMAT,
             "feature_keys": list(feature_spec.keys())}
    if model.exports_program:
      start = time.perf_counter()
      program = export_program(model, feature_spec, variables)
      program.example_inputs = None  # they would hold the variables
      torch.export.save(program, os.path.join(tmp_dir, SERVING_FN_NAME))
      self.last_trace_s = time.perf_counter() - start
      extra.update({
          "format": PROGRAM_FORMAT, "torch": torch.__version__,
          # [key, shape, dtype] in the program's input order.
          "variables": [[key, list(value.shape),
                         str(value.dtype)[len("torch."):]]
                        for key, value in variables.items()]})
    variables_io.save_variables(
        os.path.join(tmp_dir, export_utils.VARIABLES_NPZ),
        bridge.state_dict_to_variables(variables))
    export_utils.write_spec_assets(tmp_dir, feature_spec, extra=extra,
                                   global_step=global_step)
    return export_utils.publish(tmp_dir, final_dir)
