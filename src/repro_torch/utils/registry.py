"""A tiny name->factory registry used across the framework.

Used for architecture configs (``--arch <id>``), platform component images
(the "image registry" analog), in-app control policies, and benchmark tables.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name: str, obj: Optional[Any] = None) -> Callable:
        """Register ``obj`` under ``name``; usable as a decorator."""
        if obj is not None:
            self._register(name, obj)
            return obj

        def deco(fn):
            self._register(name, fn)
            return fn

        return deco

    def _register(self, name: str, obj: Any) -> None:
        if name in self._items:
            raise KeyError(f"{self.kind} {name!r} already registered")
        self._items[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._items:
            known = ", ".join(sorted(self._items))
            raise KeyError(f"unknown {self.kind} {name!r}; known: {known}")
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def names(self) -> list:
        return sorted(self._items)

    def items(self) -> Iterator:
        return iter(sorted(self._items.items()))

    def __len__(self) -> int:
        return len(self._items)
