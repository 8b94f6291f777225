"""Config wrapper: attribute access over the dict schema.

A copy of ``hopvae_tpu/config.py`` (``MakeConfig``, ``load_config``,
``apply_overrides``); the port keeps its own because importing any
``hopvae_tpu`` module imports JAX.
"""

from __future__ import annotations

import ast
import sys


class MakeConfig:
    def __init__(self, config: dict):
        self.__dict__ = dict(config)

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    def __repr__(self) -> str:  # pragma: no cover
        return f"MakeConfig({self.__dict__})"


def load_config(name: str) -> MakeConfig:
    from hopvae_torch.configs import get_config

    return MakeConfig(get_config(name))


def apply_overrides(config, sets: list, *, config_name: str = "") -> None:
    """Apply ``--set KEY=VALUE`` overrides in place (values parsed as
    Python literals when possible). Warns on keys absent from the config;
    ``prior_*`` keys are config-dependent and never warn."""
    for kv in sets:
        key, eq, val = kv.partition("=")
        if not eq:
            raise ValueError(f"--set expects KEY=VALUE, got {kv!r}")
        if key not in config.__dict__ and not key.startswith("prior_"):
            print(
                f"warning: --set {key} is not a {config_name or 'known'} "
                f"config key (setting it anyway)",
                file=sys.stderr,
            )
        try:
            config.__dict__[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            config.__dict__[key] = val
