"""ExecutableLedger: build counts and dispatch-time attribution.

Counterpart of ``tensor2robot_tpu/obs/ledger.py``. Every built program of
the port (a CUDA graph a bucket of the fleet policy, the megastep, the
Anakin period, the device ring's functions, the Bellman label and TD
closures, the host train step) keeps a ``compile_counts`` dict whose
values the tests hold at exactly 1: built once, never rebuilt. The ledger
gathers such counts in one place and joins them with dispatch counts and
measured seconds into each program's share of the time; the replay loop
owns one and hands it to every program it builds.

A program registers with a name, a device label, its shapes and its
scoring tier. A CUDA graph has no ``cost_analysis``, so ``register`` takes
``flops=`` and ``bytes=`` where the caller knows them and leaves them
``None`` otherwise; the estimated MFU is then null. The loops count a
dispatch's operations once, at build time, with
``torch.utils.flop_counter.FlopCounterMode`` over one eager run of the
body the graph captures, outside any capture (the mode counts this
thread's operations, and runs them unchanged). Two differences from the
JAX ledger's XLA ``cost_analysis``:

- the port counts a whole dispatch: the megastep's count is K times one
  learn iteration's, the Anakin period's the periods of a dispatch that
  learns, so ``estimated_mfu`` is the dispatch's rate over the peak. XLA
  counts a scanned body once, so the JAX figure is one iteration's;
- ``FlopCounterMode`` counts matrix products and convolutions (forward
  and backward); XLA's count adds the elementwise work, so the JAX figure
  of a program is the larger. ``bytes`` stays ``None``.

Timing: ``record_dispatch`` seconds are host seconds around the dispatch.
A call site that ends in a wait it already has (the fleet policy's copy
out, the megastep's and the Anakin period's metrics readback, the Bellman
closures' numpy readback, the health reductions' floats) records the
device work and the copy back. A call site that fires and forgets (the
device ring's host extend and priority write, the host train step)
records its launches only, a lower bound. No call site adds a wait for
the ledger. Shares are taken of the run's window; where threads overlap
(collectors replaying ``cem_bucket_*`` while the learner dispatches) they
can sum past 1.0, and nothing clips them.

``check_compile_ledger`` is the one shared assertion the smokes use: every
program built exactly once.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

# Peak FLOP/s keyed by substrings of a device's name. The H100's is the
# card's published bf16 dense peak (NVIDIA's data sheet, SXM part, at
# 700 W), a spec figure and not a measurement; the rest are the JAX
# table's TPU specs, kept so the two ledgers read the same names.
CHIP_PEAKS = {
    "h100": 989e12,
    "v5 lite": 197e12,
    "v5e": 197e12,
    "v5p": 459e12,
    "v4": 275e12,
    "v6": 918e12,
}


def peak_flops_for(device_kind: Optional[str]) -> Optional[float]:
  """Peak FLOP/s for a device kind; None when unknown (e.g. cpu)."""
  if not device_kind:
    return None
  kind = device_kind.lower()
  for key, peak in CHIP_PEAKS.items():
    if key in kind:
      return peak
  return None


class ExecutableEntry:
  """One program's ledger row (guarded by the owning ledger's lock)."""

  __slots__ = ("name", "device", "shapes", "dtype", "compiles",
               "dispatches", "seconds", "flops_per_dispatch",
               "bytes_per_dispatch")

  def __init__(self, name: str):
    self.name = name
    self.device: Optional[str] = None
    self.shapes: Optional[dict] = None
    self.dtype: Optional[str] = None
    self.compiles = 0
    self.dispatches = 0
    self.seconds = 0.0
    self.flops_per_dispatch: Optional[float] = None
    self.bytes_per_dispatch: Optional[float] = None


class ExecutableLedger:
  """Thread-safe name -> ExecutableEntry map with an attribution readout."""

  def __init__(self):
    self._entries: Dict[str, ExecutableEntry] = {}
    self._lock = threading.Lock()

  # -- recording -------------------------------------------------------------

  def register(self, name: str, device=None,
               shapes: Optional[dict] = None,
               dtype: Optional[str] = None,
               flops: Optional[float] = None,
               bytes: Optional[float] = None) -> str:  # noqa: A002
    """One build of ``name``; a repeat registration bumps its count (the
    rebuild the smokes assert against). ``device`` is any str()-able
    placement label; ``dtype`` tags the program's scoring tier ("f32",
    "bf16", "int8") so ``attribution`` splits the time by tier;
    ``flops``/``bytes`` are a dispatch's operations and bytes where the
    caller knows them."""
    with self._lock:
      entry = self._entries.get(name)
      if entry is None:
        entry = self._entries[name] = ExecutableEntry(name)
      entry.compiles += 1
      if device is not None:
        entry.device = str(device)
      if shapes is not None:
        entry.shapes = dict(shapes)
      if dtype is not None:
        entry.dtype = str(dtype)
      if flops is not None:
        entry.flops_per_dispatch = float(flops)
      if bytes is not None:
        entry.bytes_per_dispatch = float(bytes)
    return name

  def record_dispatch(self, name: str, seconds: float,
                      count: int = 1) -> None:
    """Adds one (or ``count``) dispatches and their measured seconds. An
    unregistered name is created with compiles=0, so a dispatch recorded
    before its registration shows in the attribution."""
    with self._lock:
      entry = self._entries.get(name)
      if entry is None:
        entry = self._entries[name] = ExecutableEntry(name)
      entry.dispatches += count
      entry.seconds += float(seconds)

  # -- readout ---------------------------------------------------------------

  @property
  def compile_counts(self) -> Dict[str, int]:
    """{name: builds}."""
    with self._lock:
      return {name: entry.compiles
              for name, entry in sorted(self._entries.items())}

  def names(self) -> List[str]:
    with self._lock:
      return sorted(self._entries)

  def attribution(self, wall_seconds: Optional[float] = None,
                  device_kind: Optional[str] = None) -> dict:
    """Each program's share of the time and its estimated MFU.

    With ``wall_seconds`` (the measured window) a share is seconds / wall;
    without it the shares are normalised over the attributed seconds.
    ``tier_shares`` sums the rows by scoring tier.
    """
    with self._lock:
      entries = sorted(self._entries.values(), key=lambda e: -e.seconds)
      rows = []
      attributed = sum(entry.seconds for entry in entries)
      denominator = wall_seconds if wall_seconds else attributed
      peak = peak_flops_for(device_kind)
      for entry in entries:
        mfu = None
        if peak and entry.flops_per_dispatch and entry.seconds > 0:
          mfu = round(entry.flops_per_dispatch * entry.dispatches
                      / entry.seconds / peak, 4)
        rows.append({
            "name": entry.name,
            "device": entry.device,
            "shapes": entry.shapes,
            "dtype": entry.dtype,
            "compiles": entry.compiles,
            "dispatches": entry.dispatches,
            "seconds_total": round(entry.seconds, 4),
            "device_time_share": round(
                entry.seconds / denominator, 4) if denominator else 0.0,
            "flops_per_dispatch": entry.flops_per_dispatch,
            "bytes_per_dispatch": entry.bytes_per_dispatch,
            "estimated_mfu": mfu,
        })
    shares = sum(row["device_time_share"] for row in rows)
    tiers: Dict[str, dict] = {}
    for row in rows:
      tier = tiers.setdefault(row["dtype"] or "untagged", {
          "executables": 0, "dispatches": 0, "seconds_total": 0.0,
          "device_time_share": 0.0})
      tier["executables"] += 1
      tier["dispatches"] += row["dispatches"]
      tier["seconds_total"] += row["seconds_total"]
      tier["device_time_share"] += row["device_time_share"]
    for tier in tiers.values():  # one rounding step, after the sums
      tier["seconds_total"] = round(tier["seconds_total"], 4)
      tier["device_time_share"] = round(tier["device_time_share"], 4)
    return {
        "wall_seconds": round(wall_seconds, 4) if wall_seconds else None,
        "attributed_seconds": round(attributed, 4),
        "attributed_share": round(shares, 4),
        "device_kind": device_kind,
        "peak_flops": peak,
        "tier_shares": tiers,
        "executables": rows,
        "note": (
            "device_time_share = measured dispatch seconds / "
            "wall_seconds (host clock around each dispatch and the wait "
            "on its result; launches only where the call site waits for "
            "nothing, a lower bound). Threads overlap, so shares can sum "
            "past 1.0. flops_per_dispatch counts a whole dispatch's "
            "matrix products and convolutions (FlopCounterMode); "
            "estimated_mfu is null without them or a known peak; the "
            "H100's peak is its published bf16 dense figure, not a "
            "measurement."),
    }


def _flatten_counts(counts: dict, prefix: str = "") -> Dict[str, int]:
  """Flattens the fleet's nested {replica: {bucket: n}} ledgers."""
  flat: Dict[str, int] = {}
  for key, value in counts.items():
    label = f"{prefix}{key}"
    if isinstance(value, dict):
      flat.update(_flatten_counts(value, prefix=f"{label}/"))
    else:
      flat[label] = value
  return flat


def check_compile_ledger(counts: dict, require: Iterable[str] = (),
                         forbid: Iterable[str] = ()) -> Dict[str, int]:
  """The shared smoke assertion: every program built exactly once.

  Args:
    counts: a build-count mapping, flat ({name: n}) or nested (the fleet
      router's {replica: {bucket: n}}).
    require: names (or prefixes ending in "*") that must be present.
    forbid: names that must be absent (programs a fused path subsumes).

  Returns the flattened counts; raises AssertionError naming the
  offending entries otherwise.
  """
  flat = _flatten_counts(dict(counts))
  if not flat:
    raise AssertionError(
        "empty compile ledger: nothing registered a compile")
  wrong = {name: n for name, n in flat.items() if n != 1}
  if wrong:
    raise AssertionError(f"executables not compiled exactly once: {wrong}")
  for name in require:
    if name.endswith("*"):
      prefix = name[:-1]
      if not any(key.startswith(prefix) for key in flat):
        raise AssertionError(
            f"no executable matching {name!r} in ledger: {sorted(flat)}")
    elif name not in flat:
      raise AssertionError(
          f"required executable {name!r} missing from ledger: "
          f"{sorted(flat)}")
  for name in forbid:
    if name in flat:
      raise AssertionError(
          f"forbidden executable {name!r} present in ledger "
          f"(a fused path should have subsumed it): {sorted(flat)}")
  return flat
