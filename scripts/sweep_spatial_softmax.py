#!/usr/bin/env python3
"""Where K1's channel-group kernel spends its time on one CUDA GPU.

    python3 scripts/sweep_spatial_softmax.py [--out DIR]

On the served pose_env map, (B, 16, 16, 64) NHWC contiguous at batch 1 and
64, bfloat16, it prints one JSON line each for:

- ``sweep``: the device time of one call (``chip_smoke.device_ms``: a CUDA
  graph of 50 calls) of the warp-per-(b, c) kernel, of the channel-group
  kernel as built, and of copies of ``csrc/spatial_softmax.cu`` rebuilt
  with other warps a block, pixels a load batch, and a fixed cluster
  split in place of the launch's rule, each with its largest error
  against the plain version and its registers;
- ``phases``: one launch at a time outside a graph, an instrumented copy
  of each kernel: the span from the first block's start to the last
  block's end (``%globaltimer``, ns), and for the channel-group kernel
  the largest cycle count (``clock64``) any block's thread 0 spent on its
  loads and folds, the block's merge, the first cluster barrier, the
  cluster merge and store, and the exit barrier.

The copies are built with ``ops._build.NVCC_FLAGS`` under ``--out``. Run
from the repository root.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import re
import subprocess
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

# (warps a block, pixels a load batch, cluster split; 0 = the launch's rule)
_VARIANTS = ((8, 8, 1), (8, 8, 2), (8, 8, 4), (8, 8, 8), (4, 8, 0),
             (16, 8, 0), (8, 4, 0), (16, 16, 1))
_SPLIT_RULE = re.compile(r"  int split = 1;\n  while \(.*?\n  \}\n", re.S)

_TIMER = """__device__ unsigned long long g_probe[10];
__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""
_READ = """
extern "C" void t2r_probe(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[10] = {~0ull, 0, 0, 0, 0, 0, 0, ~0ull, 0, 0};
    cudaMemcpyToSymbol(g_probe, z, sizeof(z));
  } else {
    cudaMemcpyFromSymbol(out, g_probe, sizeof(unsigned long long) * 10);
  }
}
"""


def _replace(text: str, old: str, new: str) -> str:
  if text.count(old) != 1:
    raise RuntimeError(f"the kernel source no longer holds {old!r}")
  return text.replace(old, new)


def _variant(source: str, warps: int, batch: int, split: int) -> str:
  text = re.sub(r"constexpr int kChannelWarps = \d+;",
                f"constexpr int kChannelWarps = {warps};", source)
  text = re.sub(r"constexpr int kBatch = \d+;",
                f"constexpr int kBatch = {batch};", text)
  if split:
    text = _SPLIT_RULE.sub(f"  int split = {split};\n", text, count=1)
  return text


def _instrumented(source: str) -> str:
  """g_probe: [0] first channel-kernel start, [1] last end (ns), [2..6]
  phase cycles, [7] first warp-kernel start, [8] last end."""
  text = _replace(source, "namespace {\n", _TIMER + "namespace {\n")
  text = _replace(
      text, "  const int rank = static_cast<int>(cluster.block_rank());\n",
      "  const int rank = static_cast<int>(cluster.block_rank());\n"
      "  const long long k0 = clock64();\n"
      "  if (threadIdx.x == 0) atomicMin(&g_probe[0], probe_ns());\n")
  text = _replace(text, "  parts[warp][2 * lane] = p0;\n",
                  "  const long long k1 = clock64();\n"
                  "  parts[warp][2 * lane] = p0;\n")
  text = _replace(
      text, "  cluster.sync();  // every block's partials are written\n",
      "  const long long k2 = clock64();\n"
      "  cluster.sync();  // every block's partials are written\n"
      "  const long long k3 = clock64();\n")
  text = _replace(
      text,
      "  cluster.sync();  // no block leaves while the first reads its "
      "partials\n}",
      "  const long long k4 = clock64();\n"
      "  cluster.sync();  // no block leaves while the first reads its "
      "partials\n"
      "  if (threadIdx.x == 0) {\n"
      "    const long long k5 = clock64();\n"
      "    atomicMax(&g_probe[1], probe_ns());\n"
      "    const long long d[5] = {k1 - k0, k2 - k1, k3 - k2, k4 - k3, "
      "k5 - k4};\n"
      "    for (int i = 0; i < 5; ++i) atomicMax(&g_probe[2 + i], "
      "(unsigned long long)d[i]);\n"
      "  }\n}")
  text = _replace(
      text, "  const int lane = threadIdx.x & 31;\n  const int64_t row =",
      "  const int lane = threadIdx.x & 31;\n"
      "  if (threadIdx.x == 0) atomicMin(&g_probe[7], probe_ns());\n"
      "  const int64_t row =")
  text = _replace(
      text,
      "    store_float(out_row + channels + c, p.sy * inv_s);\n  }\n}",
      "    store_float(out_row + channels + c, p.sy * inv_s);\n"
      "    atomicMax(&g_probe[8], probe_ns());\n  }\n}")
  return text + _READ


def _build(sources: dict, out_dir: str, nvcc: str, flags) -> dict:
  """Builds each named source into a library, all nvcc runs at once."""
  procs = {}
  for name, text in sources.items():
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
      f.write(text)
    procs[name] = (path[:-3] + ".so", subprocess.Popen(
        [nvcc, *flags, "-o", path[:-3] + ".so", path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  built = {}
  for name, (library, proc) in procs.items():
    log = proc.communicate()[0]
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    registers = re.findall(r"channels_kernel.*?Used (\d+) registers", log,
                           re.S)
    built[name] = (ctypes.CDLL(library), sorted(set(registers)))
  return built


def _entry(library, name: str):
  fn = getattr(library, name)
  fn.restype = ctypes.c_int
  fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                 + [ctypes.c_int64] * 8 + [ctypes.c_float, ctypes.c_void_p])
  return fn


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--out", default=os.path.join(_ROOT, "build",
                                                    "sweeps"))
  parser.add_argument("--seed", type=int, default=0)
  args = parser.parse_args(argv)

  import torch
  if not torch.cuda.is_available():
    print("sweep_spatial_softmax: CUDA is not available.", file=sys.stderr)
    return 2
  from chip_smoke import device_ms, nvidia_smi
  from tensor2robot_tpu_torch.ops import _build as build
  ss = importlib.import_module("tensor2robot_tpu_torch.ops.spatial_softmax")
  os.makedirs(args.out, exist_ok=True)
  with open(os.path.join(build.CSRC_DIR, "spatial_softmax.cu")) as f:
    source = f.read()
  sources = {"w%d_b%d_s%d" % v: _variant(source, *v) for v in _VARIANTS}
  sources["instrumented"] = _instrumented(source)
  built = _build(sources, args.out, build._nvcc(), build.NVCC_FLAGS)
  card = nvidia_smi()
  dev = torch.device("cuda")
  rng = np.random.default_rng(args.seed)
  maps = {batch: torch.from_numpy(rng.standard_normal(
      (batch, 16, 16, 64)).astype(np.float32)).to(dev, torch.bfloat16)
          for batch in (1, 64)}

  def call(fn, x, out):
    err = fn(x.data_ptr(), out.data_ptr(), 1, *x.shape, *x.stride(), 1.0,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
      raise RuntimeError(f"launch failed with CUDA error {err}")

  for batch, x in maps.items():
    want = ss.spatial_softmax_reference(x).float()
    row = {"warp": device_ms(torch, lambda: ss._launch(x, 1.0, "warp")),
           "channels": device_ms(
               torch, lambda: ss._launch(x, 1.0, "channels"))}
    for name in sources:
      if name == "instrumented":
        continue
      library, registers = built[name]
      fn = _entry(library, "t2r_spatial_softmax_channels")
      out = torch.empty((batch, 128), dtype=x.dtype, device=dev)
      call(fn, x, out)
      torch.cuda.synchronize()
      row[name] = {"ms": device_ms(torch, lambda: call(fn, x, out)),
                   "max_abs_err": float((out.float() - want).abs().max()),
                   "registers": registers}
    print(json.dumps({"sweep": {"batch": batch, **row}, "card": card}),
          flush=True)

  library, _ = built["instrumented"]
  counters = (ctypes.c_ulonglong * 10)()
  for batch, x in maps.items():
    out = torch.empty((batch, 128), dtype=x.dtype, device=dev)
    row = {}
    for kernel, entry in (("channels", "t2r_spatial_softmax_channels"),
                          ("warp", "t2r_spatial_softmax")):
      fn = _entry(library, entry)
      readings = []
      for _ in range(40):
        library.t2r_probe(counters, 1)
        torch.cuda.synchronize()
        call(fn, x, out)
        torch.cuda.synchronize()
        library.t2r_probe(counters, 0)
        c = list(counters)
        readings.append([c[1] - c[0], *c[2:7]] if kernel == "channels"
                        else [c[8] - c[7]])
      median = np.median(np.array(readings[5:], dtype=np.float64), axis=0)
      names = (["span_ns", "loads_and_folds", "block_merge",
                "cluster_barrier", "cluster_merge_and_store",
                "exit_barrier"] if kernel == "channels" else ["span_ns"])
      row[kernel] = dict(zip(names, median.tolist()))
    print(json.dumps({"phases": {"batch": batch, **row}, "card": card}),
          flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
