"""The width context of a width-sharded step (`skyhdr`'s `shard_width=True`).

Inside `width_across(ring)` each spatial op of the port holds one width
shard of every panorama-shaped map: process `ring.index` of `ring.n`
holds columns [index * w_local, (index + 1) * w_local) of a map of width
w_local * n, and the ops take their halos, sums and gathers through `ring`
(`skyhdr_torch.parallel.spatial.WidthRing`). Outside it (`current()` is
None) every op holds the whole panorama, as before. This module holds the
context alone, so that the layers and ops read it without importing the
process groups.
"""

from __future__ import annotations

import contextlib

_RING = None


@contextlib.contextmanager
def width_across(ring):
    """Within: the spatial ops work on width shards through `ring` (None:
    on whole panoramas)."""
    global _RING
    outer, _RING = _RING, ring
    try:
        yield
    finally:
        _RING = outer


def current():
    """The active `WidthRing`, or None."""
    return _RING
