"""Builds and loads the port's native code: by hand, bound with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, at its first use, under ``build/torch_kernels/``
beside the package, in a directory keyed by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads at once.
``build_all`` starts one ``nvcc`` per source, all together. Nothing builds
at import: the CPU has no ``nvcc``, and the CPU tests import every module.

Host code (``csrc/<name>.cc``: the record reader's CRC32C) builds the same
way with the host C++ compiler (``build_host``), on the CPU too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PACKAGE_DIR), "build",
                          "torch_kernels")
KERNEL_SOURCES = ("spatial_softmax", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # name -> nvcc's output (ptxas usage)


def _nvcc() -> str:
  home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
  candidates = [os.path.join(home, "bin", "nvcc")] if home else []
  candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
  for path in candidates:
    if path and os.path.exists(path):
      return path
  raise RuntimeError(
      "nvcc not found (set CUDA_HOME): the port's CUDA kernels build from "
      f"the sources in {CSRC_DIR} at first use.")


def _library_path(name: str, suffix: str = ".cu",
                  flags: Sequence[str] = NVCC_FLAGS) -> str:
  with open(os.path.join(CSRC_DIR, f"{name}{suffix}"), "rb") as f:
    digest = hashlib.sha256(f.read())
  digest.update(" ".join(flags).encode())
  return os.path.join(BUILD_ROOT, digest.hexdigest()[:16], f"lib{name}.so")


def build_all(names: Sequence[str] = KERNEL_SOURCES) -> None:
  """Builds (or finds built) and loads every named kernel library."""
  with _lock:
    pending = []
    for name in names:
      path = _library_path(name)
      if name in _libraries or os.path.exists(path):
        continue
      os.makedirs(os.path.dirname(path), exist_ok=True)
      tmp = f"{path}.{os.getpid()}.tmp"
      proc = subprocess.Popen(
          [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")],
          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
      pending.append((name, path, tmp, proc))
    for name, _, _, proc in pending:  # wait for every nvcc before raising
      build_logs[name] = proc.communicate()[0]
    for name, path, tmp, proc in pending:
      if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name}.cu:\n{build_logs[name]}")
      os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    for name in names:
      if name not in _libraries:
        _libraries[name] = ctypes.CDLL(_library_path(name))


def load_library(name: str) -> ctypes.CDLL:
  """The loaded library of ``csrc/<name>.cu``, built at first use."""
  library = _libraries.get(name)
  if library is None:
    build_all((name,))
    library = _libraries[name]
  return library


def build_host(name: str) -> ctypes.CDLL:
  """The loaded library of the host source ``csrc/<name>.cc``, built with
  the host C++ compiler (``$CXX``, else ``g++``) at first use. Raises if
  it does not build."""
  key = f"host:{name}"
  with _lock:
    library = _libraries.get(key)
    if library is not None:
      return library
    path = _library_path(name, ".cc", HOST_FLAGS)
    if not os.path.exists(path):
      os.makedirs(os.path.dirname(path), exist_ok=True)
      tmp = f"{path}.{os.getpid()}.tmp"
      compiler = os.environ.get("CXX") or "g++"
      try:
        proc = subprocess.run(
            [compiler, *HOST_FLAGS, "-o", tmp,
             os.path.join(CSRC_DIR, f"{name}.cc")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
      except FileNotFoundError as e:
        raise RuntimeError(
            f"no host C++ compiler ({compiler}) to build {name}.cc") from e
      build_logs[key] = proc.stdout
      if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed to build {name}.cc:\n"
                           f"{proc.stdout}")
      os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    library = _libraries[key] = ctypes.CDLL(path)
  return library
