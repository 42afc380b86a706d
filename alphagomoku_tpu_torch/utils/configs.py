"""Unified JSON config round-trip for every config type.

Port of the reference package's `utils/configs.py` over the port's
`MCTSConfig`, `SelfplayConfig` and `TrainConfig` (the same fields and
defaults), so that a `config.json` written by either package reads back
in the other.  Counterpart of the reference's config system (reference:
include/alphagomoku/utils/configs.hpp:23-255 — every struct has a
Json ctor + toJson; config.json is version-checked at load,
ProgramManager.cpp:376-404).  Our configs are NamedTuples/dataclasses per
module; this registry serializes any of them to plain dicts and back, plus
a versioned master config file covering engine + search + selfplay +
training, auto-created with defaults on first load (reference:
TrainingManager.cpp:20-40 auto-creates a default config then exits)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Type

CONFIG_VERSION = "1.0"


def to_dict(cfg: Any) -> dict:
    """NamedTuple / dataclass -> plain JSON-safe dict."""
    if hasattr(cfg, "_asdict"):
        d = cfg._asdict()
    elif dataclasses.is_dataclass(cfg):
        d = dataclasses.asdict(cfg)
    else:
        raise TypeError(f"not a config: {type(cfg)}")
    out = {}
    for k, v in d.items():
        if hasattr(v, "_asdict") or dataclasses.is_dataclass(v):
            out[k] = to_dict(v)
        elif hasattr(v, "name") and hasattr(v, "value"):  # enum
            out[k] = v.name
        elif isinstance(v, type):  # dtype classes etc.: skipped
            continue
        else:
            out[k] = v
    return out


def from_dict(cls: Type, data: dict) -> Any:
    """Rebuild a config, ignoring unknown keys, filling missing defaults."""
    if hasattr(cls, "_fields"):
        fields = set(cls._fields)
        kwargs = {k: v for k, v in data.items() if k in fields}
        return cls(**kwargs)
    if dataclasses.is_dataclass(cls):
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in data.items() if k in fields}
        return cls(**kwargs)
    raise TypeError(f"not a config class: {cls}")


def default_master_config() -> dict:
    """The versioned engine+training config (reference: config.json)."""
    from ..search.mcts import MCTSConfig
    from ..selfplay.selfplay import SelfplayConfig
    from ..training.train import TrainConfig

    return {
        "version": CONFIG_VERSION,
        "game": {
            "rules": "FREESTYLE",
            "rows": 15,
            "cols": 15,
            "draw_after": 225,
        },
        "network": {
            "architecture": "ConvNextPVQMraw",
            "blocks": 6,
            "filters": 64,
        },
        "search": {
            **to_dict(MCTSConfig()),
            "simulations": 400,
        },
        "selfplay": to_dict(SelfplayConfig()),
        "training": {
            k: v
            for k, v in to_dict(TrainConfig()).items()
        },
    }


def load_master_config(path: str = "config.json") -> dict:
    """Load + version-check; auto-create defaults when absent
    (reference: ProgramManager.cpp:376-404, TrainingManager.cpp:20-40)."""
    if not os.path.exists(path):
        cfg = default_master_config()
        save_master_config(cfg, path)
        return cfg
    with open(path) as fh:
        cfg = json.load(fh)
    version = cfg.get("version")
    if version != CONFIG_VERSION:
        raise ValueError(
            f"config version mismatch: file {version!r} vs supported "
            f"{CONFIG_VERSION!r} — regenerate with --configure"
        )
    return cfg


def save_master_config(cfg: dict, path: str = "config.json") -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(cfg, fh, indent=2)
    os.replace(tmp, path)
