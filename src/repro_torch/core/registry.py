"""Image registry (paper §4.2.2): hosts ACE-provided and user-provided
component images. An 'image' here is a named factory producing a component
instance — the containerization analog (DESIGN.md §2 assumption change (i)).

A component instance implements the runtime contract:

    class MyComponent:
        def start(self, ctx): ...            # ctx: repro_torch.core.agent.Context
        def stop(self): ...                  # optional

Components communicate only through resource-level services reachable from
``ctx`` (message service, file service) — never by direct reference. This is
what makes them relocatable between edge and cloud.
"""
from __future__ import annotations

from repro_torch.utils.registry import Registry

IMAGES = Registry("component image")


def image(name: str):
    """Decorator: register a component class under an image name."""
    return IMAGES.register(name)


def instantiate(name: str, params: dict):
    factory = IMAGES.get(name)
    return factory(**params)
