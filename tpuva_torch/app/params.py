"""Hierarchical parameter handling (reference: the companion project's
nested parameter dict with per-video overrides, SURVEY.md §2.1/§5.6).

The reference passed one big nested dict down its passes, with defaults
merged under per-video overrides. `Parameters` reproduces that ergonomic
(dotted-path get/set, recursive override merge) on top of the typed
PipelineConfig used by the device pipeline.

The port's copy of ``tpuva/app/params.py``, held to the original by
``tests/test_torch_app.py``.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Mapping


def _deep_merge(base: dict, override: Mapping) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Parameters:
    """Nested parameter tree with dotted-path access and override layering.

    >>> p = Parameters({"segment": {"threshold": 25.0}})
    >>> p["segment.threshold"]
    25.0
    >>> p2 = p.with_overrides({"segment": {"threshold": 40.0}})
    """

    def __init__(self, data: Mapping | None = None):
        self._data: dict = copy.deepcopy(dict(data or {}))

    def __getitem__(self, path: str) -> Any:
        node: Any = self._data
        for part in path.split("."):
            node = node[part]
        return node

    def get(self, path: str, default: Any = None) -> Any:
        try:
            return self[path]
        except (KeyError, TypeError):
            return default

    def __setitem__(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self._data
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
            return True
        except (KeyError, TypeError):
            return False

    def with_overrides(self, override: Mapping) -> "Parameters":
        return Parameters(_deep_merge(self._data, override))

    def to_dict(self) -> dict:
        return copy.deepcopy(self._data)

    def to_json(self) -> str:
        return json.dumps(self._data, indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Parameters":
        return Parameters(json.loads(s))

    def __repr__(self):
        return f"Parameters({self._data!r})"
