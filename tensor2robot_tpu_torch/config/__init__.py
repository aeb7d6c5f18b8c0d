"""t2r_config: dependency injection for run definitions.

Counterpart of ``tensor2robot_tpu/config``: gin's two-level UX (config
files + binding overrides, with the operative config dumped to model_dir)
without gin: `@configurable` callables, `name.param = value` bindings with
`@ref`, `@ref()` and `%macro` values, file+override parsing, and the
operative-config dump. The port's registry is its own.
"""

from tensor2robot_tpu_torch.config.config import (
    bind,
    clear_config,
    configurable,
    get_configurable,
    operative_config_str,
    parse_config,
    parse_config_files_and_bindings,
    query_binding,
)

__all__ = [
    "bind",
    "clear_config",
    "configurable",
    "get_configurable",
    "operative_config_str",
    "parse_config",
    "parse_config_files_and_bindings",
    "query_binding",
]
