"""Bucketed slot scheduling for image requests (host-side, numpy).

A port of the conv half of ``repro/serve/scheduler.py``: :class:`ConvRequest`
carries an arbitrary-size image, :class:`SpatialBucketer` maps it onto one of
a small set of ``(H, W)`` buckets (pad on entry, slice on exit), and
:class:`SlotPool` does the per-bucket slot admission and occupancy
accounting that ``launch.conv_serve.ConvServer`` drives.  Conv inference is
single-shot, so a slot lives for one batch step; the "continuous" part is
that admission refills freed slots from the queue every step.  The
reference's fault-injection probe is not ported.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Outcome", "ConvRequest", "SpatialBucketer", "SlotPool"]


class Outcome(enum.Enum):
    """Every submitted request terminates in exactly one of the three
    bottom states.

      PENDING    in flight (queued or slotted)
      OK         served — ``logits`` holds the answer
      TIMED_OUT  deadline passed before a slot; completed without running
      REJECTED   shed at admission — the bounded queue was full
    """

    PENDING = "pending"
    OK = "ok"
    TIMED_OUT = "timed_out"
    REJECTED = "rejected"


@dataclasses.dataclass
class ConvRequest:
    """One image-classification request.

    ``image`` is host-side ``[H, W, C]``; the server stamps ``t_submit`` /
    ``t_done`` with its injected clock, so ``latency`` is queue wait plus
    batched service time.  ``deadline`` is absolute on that clock; ``done``
    means terminated (any non-PENDING outcome), not served.
    """

    rid: int
    image: np.ndarray                    # [H, W, C] float
    t_submit: float = 0.0
    t_done: float = 0.0
    bucket: Optional[Tuple[int, int]] = None
    logits: Optional[np.ndarray] = None  # [n_classes] when outcome is OK
    done: bool = False
    deadline: Optional[float] = None
    outcome: Outcome = Outcome.PENDING

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


class SpatialBucketer:
    """Map arbitrary ``(H, W)`` requests onto a small bucket set.

    ``bucket_for`` picks the smallest bucket (by padded area) that contains
    the image; ``pad`` zero-pads it bottom/right up to that bucket.  A
    classifier's logits need no crop on exit.
    """

    def __init__(self, buckets: Sequence[Tuple[int, int]]):
        if not buckets:
            raise ValueError("need at least one (H, W) bucket")
        self.buckets = tuple(sorted((int(h), int(w)) for h, w in buckets))

    def bucket_for(self, h: int, w: int) -> Tuple[int, int]:
        fits = [(bh * bw, (bh, bw)) for bh, bw in self.buckets
                if bh >= h and bw >= w]
        if not fits:
            raise ValueError(f"image ({h}, {w}) exceeds every bucket "
                             f"{list(self.buckets)}")
        return min(fits)[1]

    def pad(self, image: np.ndarray,
            bucket: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Zero-pad ``[H, W, C]`` bottom/right up to its bucket."""
        h, w = image.shape[:2]
        bh, bw = bucket if bucket is not None else self.bucket_for(h, w)
        pad = [(0, bh - h), (0, bw - w)] + [(0, 0)] * (image.ndim - 2)
        return np.pad(image, pad)


class SlotPool:
    """Per-bucket slot accounting and achieved-occupancy bookkeeping.

    Each bucket owns ``batch`` slots.  ``admit`` moves queued requests into
    free slots; ``drain`` empties the filled slots for one batch step and
    records ``filled / batch``.  ``max_queue`` bounds each bucket's queue:
    a full queue makes ``enqueue`` return False (the server sheds the
    request) instead of growing without limit; None leaves it unbounded.
    """

    def __init__(self, buckets: Sequence[Tuple[int, int]], batch: int,
                 max_queue: Optional[int] = None):
        self.batch = int(batch)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.queues: Dict[Tuple[int, int], deque] = {
            b: deque() for b in buckets}
        self.slots: Dict[Tuple[int, int], List[ConvRequest]] = {
            b: [] for b in buckets}
        self._occ_samples: Dict[Tuple[int, int], List[float]] = {
            b: [] for b in buckets}

    def enqueue(self, req: ConvRequest) -> bool:
        """Queue for admission; False (queue untouched) when it is full."""
        q = self.queues[req.bucket]
        if self.max_queue is not None and len(q) >= self.max_queue:
            return False
        q.append(req)
        return True

    def admit(self) -> int:
        """Fill free slots from each bucket's queue; -> requests admitted."""
        moved = 0
        for b, q in self.queues.items():
            free = self.batch - len(self.slots[b])
            for _ in range(min(free, len(q))):
                self.slots[b].append(q.popleft())
                moved += 1
        return moved

    def sweep(self, predicate) -> List[ConvRequest]:
        """Remove and return every *queued* request matching ``predicate``
        (slotted requests are already committed to the next batch)."""
        removed: List[ConvRequest] = []
        for b, q in self.queues.items():
            kept: deque = deque()
            for r in q:
                (removed if predicate(r) else kept).append(r)
            self.queues[b] = kept
        return removed

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot (excludes slotted ones)."""
        return sum(len(q) for q in self.queues.values())

    def drain(self, bucket: Tuple[int, int]) -> List[ConvRequest]:
        """Take the bucket's filled slots for one step and record occupancy."""
        batch = self.slots[bucket]
        if batch:
            self._occ_samples[bucket].append(len(batch) / self.batch)
        self.slots[bucket] = []
        return batch

    @property
    def pending(self) -> int:
        return (sum(len(q) for q in self.queues.values())
                + sum(len(s) for s in self.slots.values()))

    def occupancy(self, bucket: Optional[Tuple[int, int]] = None) -> float:
        """Mean achieved batch occupancy over executed steps (0 if none),
        pooled over every bucket or for one bucket."""
        samples = (self._occ_samples[bucket] if bucket is not None else
                   [s for ss in self._occ_samples.values() for s in ss])
        if not samples:
            return 0.0
        return float(np.mean(samples))
