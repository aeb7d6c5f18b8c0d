"""Versioned export directories + spec assets: the predictor's subset.

Counterpart of ``tensor2robot_tpu/export/export_utils.py``. An export root
holds numeric version directories; each holds ``variables.npz``
(``export/variables_io.py``) and the JSON spec asset ``t2r_assets.json``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

SPEC_ASSET_NAME = "t2r_assets.json"
VARIABLES_NPZ = "variables.npz"


def normalize_serving_outputs(outputs) -> dict:
  """The serving output contract: a flat {str: tensor} dict."""
  if hasattr(outputs, "items"):
    return {str(k): v for k, v in outputs.items()}
  return {"inference_output": outputs}


def list_export_versions(export_root: str) -> List[int]:
  """Sorted numeric version subdirs of export_root."""
  if not os.path.isdir(export_root):
    return []
  versions = []
  for name in os.listdir(export_root):
    if name.isdigit() and os.path.isdir(os.path.join(export_root, name)):
      versions.append(int(name))
  return sorted(versions)


def read_spec_assets(
    export_dir: str,
) -> Tuple[ts.TensorSpecStruct, Optional[ts.TensorSpecStruct], dict]:
  """Reads back (feature_spec, label_spec, extra) from the JSON asset."""
  with open(os.path.join(export_dir, SPEC_ASSET_NAME)) as f:
    payload = json.load(f)
  feature_spec = ts.from_serialized(json.dumps(payload["feature_spec"]))
  label_spec = (ts.from_serialized(json.dumps(payload["label_spec"]))
                if payload.get("label_spec") is not None else None)
  return feature_spec, label_spec, payload.get("extra", {})
