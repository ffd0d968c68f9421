"""Layer / pooling registry: a name -> module-class map so config-driven
code can build layers by name (see FSWConv.from_config for the config-dict
overrides)."""
from __future__ import annotations

from typing import Callable, Dict

_LAYERS: Dict[str, type] = {}
_POOLINGS: Dict[str, type] = {}


def register_layer(name: str) -> Callable[[type], type]:
    def deco(cls):
        _LAYERS[name] = cls
        return cls
    return deco


def register_pooling(name: str) -> Callable[[type], type]:
    def deco(cls):
        _POOLINGS[name] = cls
        return cls
    return deco


def get_layer(name: str) -> type:
    return _LAYERS[name]


def get_pooling(name: str) -> type:
    return _POOLINGS[name]


def available_layers():
    return sorted(_LAYERS)


def available_poolings():
    return sorted(_POOLINGS)
