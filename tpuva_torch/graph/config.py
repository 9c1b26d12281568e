"""Typed pipeline configuration tree — a copy of ``tpuva/graph/config.py``.

The port imports nothing from the JAX package, so it carries this copy of
the dataclasses; ``tests/test_torch_pipeline.py`` pins it to the original
(field names, defaults, JSON form). Every function of the port reads its
config by attribute only, so ``tpuva.graph.config.PipelineConfig`` objects
work unchanged. The canonical pipeline order and each knob's semantics
are documented in the original module.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class BlurConfig:
    ksize: int = 5
    sigma: float = 0.0


@dataclass(frozen=True)
class MedianConfig:
    ksize: int = 3


@dataclass(frozen=True)
class MorphConfig:
    ksize: int = 3
    shape: str = "rect"
    iterations: int = 1


@dataclass(frozen=True)
class BackgroundConfig:
    alpha: float = 0.02
    init: str = "first"


@dataclass(frozen=True)
class SegmentConfig:
    threshold: float | str = 25.0
    min_area: int = 10
    max_blobs: int = 8


@dataclass(frozen=True)
class TrackConfig:
    max_dist: float = 50.0
    death_patience: int = 5
    max_tracks: int = 16
    assigner: str = "greedy"  # 'greedy' | 'hungarian'


@dataclass(frozen=True)
class PipelineConfig:
    background: BackgroundConfig = field(default_factory=BackgroundConfig)
    blur: Optional[BlurConfig] = None
    median: Optional[MedianConfig] = None
    morph_open: Optional[MorphConfig] = None
    morph_close: Optional[MorphConfig] = None
    segment: SegmentConfig = field(default_factory=SegmentConfig)
    track: TrackConfig = field(default_factory=TrackConfig)
    batch: int = 16

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "PipelineConfig":
        d = json.loads(s)

        def opt(cls, key):
            return cls(**d[key]) if d.get(key) is not None else None

        return PipelineConfig(
            background=BackgroundConfig(**d["background"]),
            blur=opt(BlurConfig, "blur"),
            median=opt(MedianConfig, "median"),
            morph_open=opt(MorphConfig, "morph_open"),
            morph_close=opt(MorphConfig, "morph_close"),
            segment=SegmentConfig(**d["segment"]),
            track=TrackConfig(**d["track"]),
            batch=d.get("batch", 16),
        )
