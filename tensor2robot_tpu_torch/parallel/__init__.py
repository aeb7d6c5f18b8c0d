"""The parallel tier: ranks on named meshes, and what runs over them.

Counterpart of ``tensor2robot_tpu/parallel/``. JAX has one program over a
device mesh and lets XLA place the collectives; the port has one process a
rank (``distributed.py``, ``launch.py``), a ``Mesh`` of ranks with a
process group an axis (``mesh.py``), one layer over ``torch.distributed``
(``collectives.py``), and writes the collectives where the layouts need
them: the trainer's data, ZeRO-1, FSDP and tensor parallelism
(``train/trainer.py`` with ``tp_rules.py``'s specs), ring and Ulysses
sequence parallelism. Pipeline and expert parallelism wait for
ROADMAP.md item 15c and raise by name.
"""

from tensor2robot_tpu_torch.parallel.mesh import (
    NamedSharding,
    PartitionSpec,
    batch_sharding,
    create_mesh,
    local_batch_slice,
    replicated_sharding,
    shard_batch,
)
from tensor2robot_tpu_torch.parallel.ring_attention import (
    dense_attention_reference,
    ring_attention,
)
from tensor2robot_tpu_torch.parallel.tp_rules import (
    infer_dense_tp_specs,
    infer_dense_tp_specs_from_model,
    infer_fsdp_specs,
    infer_fsdp_specs_from_model,
)
from tensor2robot_tpu_torch.parallel.ulysses_attention import (
    ulysses_attention,
)

_WAITING = "waits for ROADMAP.md item 15c (pipeline and expert parallelism)."


def _waiting(name: str):
  def refuse(*args, **kwargs):
    raise NotImplementedError(f"parallel.{name} {_WAITING}")
  refuse.__name__ = name
  return refuse


pipeline_apply = _waiting("pipeline_apply")
stack_stage_params = _waiting("stack_stage_params")
expert_parallel_moe = _waiting("expert_parallel_moe")
init_moe_params = _waiting("init_moe_params")
switch_moe = _waiting("switch_moe")
MoEParams = _waiting("MoEParams")

__all__ = [
    "create_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "local_batch_slice",
    "NamedSharding",
    "PartitionSpec",
    "ring_attention",
    "ulysses_attention",
    "dense_attention_reference",
    "pipeline_apply",
    "stack_stage_params",
    "MoEParams",
    "expert_parallel_moe",
    "init_moe_params",
    "switch_moe",
    "infer_dense_tp_specs",
    "infer_dense_tp_specs_from_model",
    "infer_fsdp_specs",
    "infer_fsdp_specs_from_model",
]
