"""Global flag registry, ``set_flags``/``get_flags`` (port of
``paddle_tpu/framework/flags.py``): the subset of flags the training step
reads. Flags initialise from ``FLAGS_*`` environment variables, as in the
reference.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Union

__all__ = ["set_flags", "get_flags", "flag"]

_DEFAULTS: Dict[str, Any] = {
    # per-step numeric checks (TrainStep raises FloatingPointError)
    "FLAGS_check_nan_inf": False,
}

_flags: Dict[str, Any] = {}


def _coerce(default: Any, raw: str) -> Any:
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def _init() -> None:
    for name, default in _DEFAULTS.items():
        raw = os.environ.get(name)
        _flags[name] = _coerce(default, raw) if raw is not None else default


_init()


def set_flags(flags: Dict[str, Any]) -> None:
    """``set_flags({'FLAGS_check_nan_inf': 1})``; an unknown name raises
    ``ValueError``."""
    for name, value in flags.items():
        if name not in _flags:
            raise ValueError(f"unknown flag {name!r}; known: {sorted(_flags)}")
        if isinstance(_DEFAULTS[name], bool) and not isinstance(value, bool):
            value = bool(value)
        _flags[name] = value


def get_flags(flags: Union[str, Iterable[str], None] = None) -> Dict[str, Any]:
    if flags is None:
        return dict(_flags)
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for name in flags:
        if name not in _flags:
            raise ValueError(f"unknown flag {name!r}")
        out[name] = _flags[name]
    return out


def flag(name: str) -> Any:
    """Fast internal accessor."""
    return _flags[name]
