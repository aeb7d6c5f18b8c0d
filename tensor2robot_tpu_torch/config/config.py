"""Minimal gin-style configuration system (no gin dependency).

Copy of ``tensor2robot_tpu/config/config.py``, with its own registry: the
same files parse to the same bindings, and the same consumed bindings
give the same operative config.

Syntax accepted in config files / binding strings:

    # comment
    train_eval_model.max_train_steps = 2000        # literal
    train_eval_model.model = @MockT2RModel()       # configured instance
    train_eval_model.export_generator = @NativeExportGenerator  # reference
    BATCH_SIZE = 64                                # macro (no dot)
    DefaultRecordInputGenerator.batch_size = %BATCH_SIZE
    nested.value = {"lr": 1e-4, "opt": @adam}      # refs inside literals

Semantics:
  - `@name` resolves to the registered configurable; `@name()` calls it
    (with its own bindings applied) at injection time.
  - Bindings fill *unsupplied* keyword arguments at call time; explicit
    call-site arguments always win.
  - `operative_config_str()` reports every binding actually consumed:
    the operative_config.gin reproducibility artifact.
"""

from __future__ import annotations

import ast
import functools
import inspect
import re
import threading
from typing import Any, Callable, Dict, Optional, Sequence

_lock = threading.RLock()
_REGISTRY: Dict[str, Callable] = {}
_BINDINGS: Dict[str, Any] = {}          # "fn.param" -> raw parsed value
_MACROS: Dict[str, Any] = {}            # "NAME" -> raw parsed value
_OPERATIVE: Dict[str, Any] = {}         # bindings actually used


class _Ref:
  """Deferred reference to a configurable: @name or @name()."""

  def __init__(self, name: str, call: bool):
    self.name = name
    self.call = call

  def resolve(self) -> Any:
    target = get_configurable(self.name)
    return target() if self.call else target

  def __repr__(self):
    return f"@{self.name}" + ("()" if self.call else "")


class _Macro:
  """Deferred macro value: %NAME."""

  def __init__(self, name: str):
    self.name = name

  def resolve(self) -> Any:
    with _lock:
      if self.name not in _MACROS:
        raise ValueError(f"Undefined macro %{self.name}")
      return _resolve(_MACROS[self.name])

  def __repr__(self):
    return f"%{self.name}"


def _resolve(value: Any) -> Any:
  """Recursively resolves _Ref/_Macro placeholders inside parsed values."""
  if isinstance(value, (_Ref, _Macro)):
    return value.resolve()
  if isinstance(value, list):
    return [_resolve(v) for v in value]
  if isinstance(value, tuple):
    return tuple(_resolve(v) for v in value)
  if isinstance(value, dict):
    return {k: _resolve(v) for k, v in value.items()}
  return value


# --- registration ----------------------------------------------------------


def configurable(fn_or_name: Any = None, *, name: Optional[str] = None):
  """Registers a function/class; fills unsupplied kwargs from bindings.

  Usable bare (`@configurable`) or with a name
  (`@configurable(name="alias")`). Classes are registered with their
  __init__ wrapped.
  """
  def _register(target: Callable, reg_name: str):
    with _lock:
      existing = _REGISTRY.get(reg_name)
      if existing is not None:
        if existing is target:  # idempotent re-registration
          return existing
        raise ValueError(f"Configurable {reg_name!r} already registered.")

    if inspect.isclass(target):
      orig_init = target.__init__

      @functools.wraps(orig_init)
      def init_wrapper(self, *args, **kwargs):
        merged = _merge_bindings(reg_name, orig_init, args, kwargs,
                                 skip_self=True)
        orig_init(self, *args, **merged)

      target.__init__ = init_wrapper
      wrapped = target
    else:
      @functools.wraps(target)
      def wrapper(*args, **kwargs):
        merged = _merge_bindings(reg_name, target, args, kwargs)
        return target(*args, **merged)

      wrapped = wrapper
    with _lock:
      _REGISTRY[reg_name] = wrapped
    return wrapped

  if fn_or_name is None:
    return lambda target: _register(target, name or target.__name__)
  if isinstance(fn_or_name, str):
    return lambda target: _register(target, fn_or_name)
  return _register(fn_or_name, name or fn_or_name.__name__)


def _merge_bindings(reg_name: str, target: Callable, args, kwargs,
                    skip_self: bool = False) -> Dict[str, Any]:
  """kwargs + bindings for params not supplied positionally or by name."""
  try:
    sig = inspect.signature(target)
  except (TypeError, ValueError):
    return dict(kwargs)
  params = list(sig.parameters.values())
  if skip_self:
    params = params[1:]
  positional_names = {
      p.name for p in params[:len(args)]
      if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)}
  merged = dict(kwargs)
  with _lock:
    relevant = {key: v for key, v in _BINDINGS.items()
                if key.startswith(reg_name + ".")}
  has_var_kw = any(p.kind == p.VAR_KEYWORD for p in params)
  valid_names = {p.name for p in params}
  for key, raw in relevant.items():
    param = key[len(reg_name) + 1:]
    if param in merged or param in positional_names:
      continue
    if param not in valid_names and not has_var_kw:
      raise ValueError(
          f"Binding {key!r} names unknown parameter {param!r} of "
          f"{reg_name} (has: {sorted(valid_names)})")
    value = _resolve(raw)
    merged[param] = value
    with _lock:
      _OPERATIVE[key] = raw
  return merged


def get_configurable(name: str) -> Callable:
  with _lock:
    if name not in _REGISTRY:
      raise ValueError(
          f"Unknown configurable {name!r}; registered: "
          f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


# --- parsing ---------------------------------------------------------------

_TOKEN_RE = re.compile(r"(@[A-Za-z_][\w.]*(?:\(\))?|%[A-Za-z_][\w]*)")
_SENTINEL = "\x00t2r\x00"


def _scan_outside_strings(text: str):
  """Yields (index, char) for every char outside quoted string literals."""
  quote = None
  escaped = False
  for i, c in enumerate(text):
    if escaped:
      escaped = False
      continue
    if c == "\\":
      escaped = True
      continue
    if quote is not None:
      if c == quote:
        quote = None
      continue
    if c in "\"'":
      quote = c
      continue
    yield i, c


def _strip_comment(line: str) -> str:
  """Removes a trailing # comment, ignoring # inside string literals."""
  for i, c in _scan_outside_strings(line):
    if c == "#":
      return line[:i]
  return line


def _has_open_brackets(text: str) -> bool:
  """True if (), [], {} are unbalanced outside string literals."""
  depth = 0
  for _, c in _scan_outside_strings(text):
    if c in "([{":
      depth += 1
    elif c in ")]}":
      depth -= 1
  return depth > 0


def _quote_tokens(text: str) -> str:
  """Wraps @ref / %macro tokens in sentinel strings, skipping tokens that
  appear inside quoted string literals (e.g. emails, gs:// paths)."""
  starts = {i for i, c in _scan_outside_strings(text) if c in "@%"}
  out = []
  pos = 0
  for match in _TOKEN_RE.finditer(text):
    if match.start() not in starts:
      continue
    out.append(text[pos:match.start()])
    out.append(repr(_SENTINEL + match.group(1)))
    pos = match.end()
  out.append(text[pos:])
  return "".join(out)


def _parse_value(text: str) -> Any:
  """Parses a rhs: python literal with @ref / %macro tokens allowed."""
  text = text.strip()
  quoted = _quote_tokens(text)
  try:
    value = ast.literal_eval(quoted)
  except (ValueError, SyntaxError) as e:
    raise ValueError(f"Cannot parse config value: {text!r}") from e

  def _decode(v: Any) -> Any:
    if isinstance(v, str) and v.startswith(_SENTINEL):
      token = v[len(_SENTINEL):]
      if token.startswith("@"):
        call = token.endswith("()")
        return _Ref(token[1:-2] if call else token[1:], call)
      return _Macro(token[1:])
    if isinstance(v, list):
      return [_decode(x) for x in v]
    if isinstance(v, tuple):
      return tuple(_decode(x) for x in v)
    if isinstance(v, dict):
      return {k: _decode(x) for k, x in v.items()}
    return v

  return _decode(value)


def parse_config(lines: str) -> None:
  """Parses newline-separated binding statements."""
  # Join continuation lines (unbalanced brackets).
  pending = ""
  for raw_line in lines.splitlines():
    line = _strip_comment(raw_line).rstrip()
    if not line.strip():
      continue
    pending = (pending + " " + line).strip() if pending else line.strip()
    if _has_open_brackets(pending):
      continue
    statement, pending = pending, ""
    if "=" not in statement:
      raise ValueError(f"Malformed config line: {statement!r}")
    target, _, rhs = statement.partition("=")
    target = target.strip()
    value = _parse_value(rhs)
    bind(target, value)
  if pending:
    raise ValueError(f"Unterminated config statement: {pending!r}")


def bind(target: str, value: Any) -> None:
  """Binds `fn.param` (or macro NAME) to a value programmatically."""
  with _lock:
    if "." in target:
      _BINDINGS[target] = value
    else:
      _MACROS[target] = value


def query_binding(target: str) -> Any:
  with _lock:
    if "." in target:
      return _resolve(_BINDINGS[target])
    return _resolve(_MACROS[target])


def parse_config_files_and_bindings(
    config_files: Optional[Sequence[str]] = None,
    bindings: Optional[Sequence[str]] = None,
) -> None:
  """The CLI contract: files first, then override bindings."""
  for path in config_files or ():
    with open(path) as f:
      parse_config(f.read())
  for statement in bindings or ():
    parse_config(statement)


def operative_config_str() -> str:
  """Bindings actually consumed so far (gin's operative_config.gin)."""
  with _lock:
    macro_lines = [f"{k} = {v!r}" for k, v in sorted(_MACROS.items())]
    lines = [f"{k} = {v!r}" for k, v in sorted(_OPERATIVE.items())]
  return "\n".join(macro_lines + lines) + "\n"


def clear_config() -> None:
  """Clears bindings/macros/operative log (tests). Registry survives."""
  with _lock:
    _BINDINGS.clear()
    _MACROS.clear()
    _OPERATIVE.clear()
