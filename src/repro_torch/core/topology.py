"""Application topology files (paper §4.4.3, Figure 4).

A topology is 'an extended YAML file containing meta information of both the
application and all components': component clarifications, parameters,
relations (``connections``), and deployment requirements (``resources``,
``labels``, ``placement``). The orchestrator turns it into a deployment plan
(a topology replica extended with ``instances``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional

# strings PyYAML writes plain: no leading digit, dot, dash or space, none
# of YAML's indicators, and not a word its resolvers read as a bool or null
_PLAIN = re.compile(r"[A-Za-z_/][A-Za-z0-9_./ -]*(?<! )\Z")
_RESOLVED = {"y", "n", "yes", "no", "true", "false", "on", "off", "null"}


def _scalar(x) -> str:
    if x is None:
        return "null"
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, int):
        return repr(x)
    if isinstance(x, float):
        if x != x or x in (float("inf"), float("-inf")):
            return {"nan": ".nan", "inf": ".inf", "-inf": "-.inf"}[repr(x)]
        text = repr(x).lower()
        return text.replace("e", ".0e", 1) if "." not in text else text
    if isinstance(x, str):
        if _PLAIN.match(x) and x.lower() not in _RESOLVED:
            return x
        return "'" + x.replace("'", "''") + "'"
    raise TypeError(f"to_yaml: cannot write {type(x).__name__} {x!r}")


def _block(node, indent: str) -> List[str]:
    """``node``'s lines in PyYAML's block style (``safe_dump`` with
    ``sort_keys=False``): a sequence under a key at the key's indent. A
    string outside ``_PLAIN`` is single-quoted, where PyYAML may write some
    plain (``a:b``, ``-x``): the text parses to the same data."""
    lines: List[str] = []
    items = node.items() if isinstance(node, dict) else \
        ((None, x) for x in node)
    for key, val in items:
        head = f"{indent}{key}:" if key is not None else f"{indent}-"
        if isinstance(val, (dict, list)) and val:
            if key is None:
                sub = _block(val, indent + "  ")
                lines.append(f"{head} {sub[0].lstrip()}")
                lines += sub[1:]
            else:
                lines.append(head)
                lines += _block(val, indent + "  " if isinstance(val, dict)
                                else indent)
        elif isinstance(val, (dict, list)):
            lines.append(f"{head} {'{}' if isinstance(val, dict) else '[]'}")
        else:
            lines.append(f"{head} {_scalar(val)}")
    return lines


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
        import yaml      # only here: the app runs without PyYAML
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
        """The text PyYAML's ``safe_dump(..., sort_keys=False)`` writes
        (``_block``), without PyYAML (the card's machine has none)."""
        return "\n".join(_block(self.to_dict(), "")) + "\n"

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
