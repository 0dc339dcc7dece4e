"""Readahead configuration.

Only the configuration is ported so far: ``BamArray.build`` accepts a
disabled ``PrefetchConfig`` and raises ``NotImplementedError`` for an
enabled one.  The stride detector (``modal_stride``, ``readahead_keys``)
waits for a later slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PrefetchConfig:
    """Static readahead knobs (see ``repro.core.prefetch``)."""

    enabled: bool = False
    window: int = 8
    min_support: float = 0.75
    max_stride: int = 64
