"""The counters of the split sums folded into the kernels that write them.

A split wgrad and a forward with the GAP rider write rows of partial sums,
and the last CTA of each column of rows sums them in the same launch
(``csrc/split_sum.cuh``).  Each column arrives on one int32 counter in
device memory, which the kernels leave at 0.  This module keeps them: one
zeroed arena per device and stream, allocated at a launch's first use and
grown (never shrunk) when a launch needs more columns, so that no launch
pays a fill.  Kernels on one stream run one after the other, so a stream's
launches may share its arena; two streams never share one.

A CUDA graph keeps the arena of the stream it was captured on, as PyTorch's
cuBLAS workspaces are kept per stream: warm the captured calls up on that
stream first, and replay graphs captured on one stream one after the other,
never at once on several streams.  A first use under capture takes a zeroed
arena of its own, allocated in the graph's pool and zeroed by the graph at
each replay.  Arenas outgrown are kept, since a captured graph may still
name them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

__all__ = ["ARENA_COUNTERS", "counters", "arenas"]

# counters an arena holds at first: one a column
ARENA_COUNTERS = 4096

_ARENAS: Dict[Tuple[int, int], torch.Tensor] = {}
_OUTGROWN: List[torch.Tensor] = []


def counters(device: torch.device, stream: int, columns: int) -> int:
    """The address of ``columns`` zeroed int32 counters for a launch on the
    stream with handle ``stream`` of CUDA ``device``."""
    key = (device.index, stream)
    arena = _ARENAS.get(key)
    if arena is not None and arena.numel() >= columns:
        return arena.data_ptr()
    size = max(columns, ARENA_COUNTERS,
               2 * arena.numel() if arena is not None else 0)
    fresh = torch.zeros(size, dtype=torch.int32, device=device)
    if torch.cuda.is_current_stream_capturing():
        # a temporary of the graph's pool, zeroed by the graph at each
        # replay; the stream's own arena stays as it was
        return fresh.data_ptr()
    if arena is not None:
        _OUTGROWN.append(arena)
    _ARENAS[key] = fresh
    return fresh.data_ptr()


def arenas() -> List[torch.Tensor]:
    """Every arena kept, outgrown ones included: each reads all zeros
    whenever no folded kernel is running."""
    return list(_ARENAS.values()) + list(_OUTGROWN)
