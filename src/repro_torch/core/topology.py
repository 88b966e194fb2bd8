"""Application topology files (paper §4.4.3, Figure 4).

A topology is 'an extended YAML file containing meta information of both the
application and all components': component clarifications, parameters,
relations (``connections``), and deployment requirements (``resources``,
``labels``, ``placement``). The orchestrator turns it into a deployment plan
(a topology replica extended with ``instances``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Resources:
    cpu: float = 0.1            # cores
    memory_mb: int = 64
    accelerator: bool = False   # needs a GPU/TPU-class node

    def fits(self, other: "Resources") -> bool:
        return (self.cpu <= other.cpu and self.memory_mb <= other.memory_mb
                and (not self.accelerator or other.accelerator))


@dataclasses.dataclass
class Component:
    name: str
    image: str                              # component image in the registry
    placement: str = "edge"                 # edge | cloud | any
    replicas: str = "one"                   # one | per_ec | per_label
    labels: List[str] = dataclasses.field(default_factory=list)
    resources: Resources = dataclasses.field(default_factory=Resources)
    connections: List[str] = dataclasses.field(default_factory=list)
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, name: str, d: Dict[str, Any]) -> "Component":
        res = d.get("resources", {})
        return cls(
            name=name,
            image=d["image"],
            placement=d.get("placement", "edge"),
            replicas=d.get("replicas", "one"),
            labels=list(d.get("labels", [])),
            resources=Resources(cpu=float(res.get("cpu", 0.1)),
                                memory_mb=int(res.get("memory_mb", 64)),
                                accelerator=bool(res.get("accelerator", False))),
            connections=list(d.get("connections", [])),
            params=dict(d.get("params", {})),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "image": self.image, "placement": self.placement,
            "replicas": self.replicas, "labels": self.labels,
            "resources": {"cpu": self.resources.cpu,
                          "memory_mb": self.resources.memory_mb,
                          "accelerator": self.resources.accelerator},
            "connections": self.connections, "params": self.params,
        }


@dataclasses.dataclass
class Topology:
    app: str
    version: int
    components: Dict[str, Component]
    services: List[str] = dataclasses.field(default_factory=lambda: ["message"])

    def __post_init__(self):
        self.validate()

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Topology":
        comps = {name: Component.from_dict(name, cd)
                 for name, cd in d.get("components", {}).items()}
        topo = cls(app=d["app"], version=int(d.get("version", 1)),
                   components=comps,
                   services=list(d.get("services", ["message"])))
        topo.validate()
        return topo

    @classmethod
    def from_yaml(cls, text: str) -> "Topology":
        import yaml      # only here: the app imports without PyYAML
        return cls.from_dict(yaml.safe_load(text))

    @classmethod
    def load(cls, path: str) -> "Topology":
        with open(path) as f:
            return cls.from_yaml(f.read())

    def to_dict(self) -> Dict[str, Any]:
        return {"app": self.app, "version": self.version,
                "services": self.services,
                "components": {n: c.to_dict()
                               for n, c in self.components.items()}}

    def to_yaml(self) -> str:
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def validate(self) -> None:
        for name, comp in self.components.items():
            assert comp.placement in ("edge", "cloud", "any"), (
                f"{name}: bad placement {comp.placement}")
            assert comp.replicas in ("one", "per_ec", "per_label"), (
                f"{name}: bad replicas {comp.replicas}")
            for conn in comp.connections:
                if conn not in self.components:
                    raise ValueError(
                        f"component {name!r} connects to unknown {conn!r}")

    def diff(self, other: "Topology") -> Dict[str, List[str]]:
        """Incremental-update support (paper §4.4.3): which components were
        added / removed / changed between two topology versions."""
        mine, theirs = self.components, other.components
        added = [n for n in theirs if n not in mine]
        removed = [n for n in mine if n not in theirs]
        changed = [n for n in mine if n in theirs
                   and mine[n].to_dict() != theirs[n].to_dict()]
        return {"added": added, "removed": removed, "changed": changed}
