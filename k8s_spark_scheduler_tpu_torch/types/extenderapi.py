"""kube-scheduler extender protocol types
(k8s.io/kube-scheduler/extender/v1, used at cmd/endpoints.go:25-41)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .objects import Pod


@dataclass
class ExtenderArgs:
    pod: Pod
    # an interned tuple on the HTTP path (serde.intern_node_names);
    # plain lists from direct callers work identically
    node_names: Sequence[str] = field(default_factory=list)


@dataclass
class ExtenderFilterResult:
    node_names: Optional[List[str]] = None
    failed_nodes: Dict[str, str] = field(default_factory=dict)
    error: str = ""
    # (candidate names, shared message) when failed_nodes is the uniform
    # all-candidates map — lets serde reuse an encoded response buffer
    # keyed by the interned tuple's identity (serde.encode_extender_
    # filter_result).  Purely an encoding hint; to_dict ignores it.
    uniform_failure: Optional[Tuple[Sequence[str], str]] = None

    def to_dict(self) -> dict:
        return {
            "NodeNames": self.node_names,
            "FailedNodes": self.failed_nodes or None,
            "Error": self.error or None,
        }
