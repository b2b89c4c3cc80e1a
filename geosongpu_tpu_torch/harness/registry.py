"""Class registry: name -> task class, filled by a decorator
(geosongpu_tpu/harness/registry.py)."""
from __future__ import annotations

from typing import Dict


class Registry:
    registry: Dict[str, type] = {}

    @classmethod
    def register(cls, target: type) -> type:
        cls.registry[target.__name__] = target
        return target

    @classmethod
    def get(cls, name: str) -> type:
        if name not in cls.registry:
            raise KeyError(
                f"Task '{name}' is not registered; known: {sorted(cls.registry)}")
        return cls.registry[name]
