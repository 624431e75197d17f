"""Source-key accounting for weight converters.

A silent schema mismatch (a checkpoint key the converter never reads, or
a renamed key it quietly skips) is the classic way a 24-layer conversion
"succeeds" while dropping weights. Converters wrap their source state
dict in :class:`TrackedDict` and, under ``strict=True``, call
:func:`verify_exhausted` — every source key must be either consumed or
matched by an explicit ignore pattern (buffers, tied weights, heads the
target model doesn't have). Missing keys already raise ``KeyError``
naturally at the access site.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable


class TrackedDict:
    """Read-only mapping that records which keys were consumed."""

    def __init__(self, sd: Dict):
        self._sd = sd
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return self._sd[k]

    def __contains__(self, k) -> bool:
        return k in self._sd

    def __iter__(self):
        return iter(self._sd)

    def __len__(self) -> int:
        return len(self._sd)

    def keys(self):
        return self._sd.keys()

    def items(self):
        return self._sd.items()

    def get(self, k, default=None):
        if k in self._sd:
            return self[k]
        return default


def verify_exhausted(
    tracked: TrackedDict, ignore: Iterable[str], what: str
) -> None:
    """Raise ValueError if any source key was neither consumed nor
    matched by an ignore regex."""
    pats = [re.compile(p) for p in ignore]
    leftover = sorted(
        k
        for k in tracked.keys()
        if k not in tracked.used and not any(p.search(k) for p in pats)
    )
    if leftover:
        shown = ", ".join(leftover[:8])
        more = f" (+{len(leftover) - 8} more)" if len(leftover) > 8 else ""
        raise ValueError(
            f"{what}: {len(leftover)} source keys not consumed by the "
            f"conversion: {shown}{more} — checkpoint schema mismatch"
        )
