"""Versioned export directories + spec assets.

Counterpart of ``tensor2robot_tpu/export/export_utils.py``. An export root
holds numeric version directories; each holds ``variables.npz``
(``export/variables_io.py``) and the spec asset twice: ``t2r_assets.json``
and its proto twin ``t2r_assets.pb`` (``proto/t2r.proto``).
A version is written into a temporary directory and published by one
rename, so a polling predictor never sees half of one.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

import torch

from tensor2robot_tpu_torch.proto import proto_utils
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

SPEC_ASSET_NAME = "t2r_assets.json"
SPEC_ASSET_PB_NAME = "t2r_assets.pb"
VARIABLES_NPZ = "variables.npz"


def normalize_serving_outputs(outputs) -> dict:
  """The serving output contract: a flat {str: tensor} dict."""
  if hasattr(outputs, "items"):
    return {str(k): v for k, v in outputs.items()}
  return {"inference_output": outputs}


def versioned_export_dir(export_root: str) -> Tuple[str, str]:
  """(tmp_dir, final_dir) for a new version, numbered from the clock and
  past every existing one: write into tmp_dir, then `publish`."""
  os.makedirs(export_root, exist_ok=True)
  version = int(time.time())
  existing = list_export_versions(export_root)
  if existing and version <= existing[-1]:
    version = existing[-1] + 1
  return (os.path.join(export_root, f".tmp-{version}"),
          os.path.join(export_root, str(version)))


def publish(tmp_dir: str, final_dir: str) -> str:
  """Publishes tmp_dir as final_dir with one rename; refuses to replace a
  published version."""
  if os.path.exists(final_dir):
    raise FileExistsError(
        f"export target already exists: {final_dir} (publishing "
        f"{tmp_dir}); refusing to clobber a published export.")
  os.rename(tmp_dir, final_dir)
  return final_dir


def garbage_collect_exports(export_root: str, keep: int) -> List[str]:
  """Removes all but the newest `keep` versions; keep <= 0 removes none.
  Returns the removed directories."""
  if keep <= 0:
    return []
  removed = []
  for version in list_export_versions(export_root)[:-keep]:
    path = os.path.join(export_root, str(version))
    shutil.rmtree(path, ignore_errors=True)
    removed.append(path)
  return removed


def resolve_export_root(generator, model_dir: Optional[str]) -> None:
  """Defaults a generator's export_root to <model_dir>/export/latest."""
  try:
    generator.export_root
  except ValueError:
    if not model_dir:
      raise ValueError(
          "Export generator has no export_root and no model_dir to "
          "default it under.") from None
    generator.export_root = os.path.join(model_dir, "export", "latest")


def fetch_variables_to_host(
    variables: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  """Device variables -> detached CPU copies, as an export writes them."""
  return {key: value.detach().to("cpu", copy=True)
          for key, value in variables.items()}


def export_and_gc(generator, variables, keep: int,
                  global_step: int = 0) -> Optional[str]:
  """One export, then version GC down to the newest `keep`.

  The chief-worker gate for export files: over several ranks only the
  primary writes (ranks publishing the same versioned directories would
  race each other and the GC), and the others return None. Every rank
  must still gather the variables before the call (``TrainState.
  full_variables`` is a collective over a mesh); gating the gather instead
  of the write would leave the primary waiting in it."""
  from tensor2robot_tpu_torch.parallel import distributed
  if not distributed.is_primary():
    return None
  export_dir = generator.export(variables, global_step=global_step)
  garbage_collect_exports(generator.export_root, keep=keep)
  return export_dir


def write_spec_assets(
    export_dir: str,
    feature_spec: ts.SpecStructure,
    label_spec: Optional[ts.SpecStructure] = None,
    extra: Optional[dict] = None,
    global_step: int = 0,
) -> str:
  """Writes the two spec assets predictors read the signature from: the
  JSON one and its proto twin (``proto/t2r.proto`` ``T2RAssets``), as the
  JAX package does. Returns the JSON one's path."""
  payload = {
      "feature_spec": json.loads(ts.to_serialized(feature_spec)),
      "label_spec": (json.loads(ts.to_serialized(label_spec))
                     if label_spec is not None else None),
      "extra": extra or {},
      "global_step": int(global_step),
  }
  path = os.path.join(export_dir, SPEC_ASSET_NAME)
  with open(path, "w") as f:
    json.dump(payload, f, indent=2, sort_keys=True)
  assets = proto_utils.make_t2r_assets(
      feature_spec, label_spec, extra=extra, global_step=global_step)
  with open(os.path.join(export_dir, SPEC_ASSET_PB_NAME), "wb") as f:
    f.write(assets.serialize())
  return path


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
  """Reads back (feature_spec, label_spec, extra): from the JSON asset, or
  from the proto twin where the JSON one is absent (an exporter that
  writes only the proto)."""
  path = os.path.join(export_dir, SPEC_ASSET_NAME)
  if not os.path.exists(path):
    with open(os.path.join(export_dir, SPEC_ASSET_PB_NAME), "rb") as f:
      assets = proto_utils.T2RAssets.parse(f.read())
    return proto_utils.parse_t2r_assets(assets)
  with open(path) as f:
    payload = json.load(f)
  feature_spec = ts.from_serialized(json.dumps(payload["feature_spec"]))
  label_spec = (ts.from_serialized(json.dumps(payload["label_spec"]))
                if payload.get("label_spec") is not None else None)
  return feature_spec, label_spec, payload.get("extra", {})
