"""Slot scheduling: continuous batching of token requests, and bucketed
slots for image requests.

:class:`ContinuousBatcher` is the port of the reference's LM batcher: a
fixed decode batch of B slots; a finished request (EOS, ``max_new_tokens``
or the cache's end) frees its slot and the next queued request prefills into
it token by token through the decode path.  Slots at different positions
share the batched decode step by being stepped in groups of equal position,
as the reference groups them.  Unlike the reference, a group's step leaves
the other groups' slots as they were: it copies their cache rows before the
step and writes them back after it, and copies nothing when every slot is
in step.  The reference writes every slot's
cache on every group's step, which overwrites an earlier position of a slot
that is ahead of the group and advances the SSM state of every other slot
once more per group, so out-of-step slots decode from a corrupted cache
there (ROADMAP §C).  Slots in step (the common case) get the reference's
results.

The conv half: :class:`ConvRequest`
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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Request", "ContinuousBatcher", "Outcome", "ConvRequest",
           "SpatialBucketer", "SlotPool"]


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


# ---------------------------------------------------------------------------
# Continuous batching of token requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # [S] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Continuous batching over ``model.decode_step`` (an ``nn.models.LM``)
    with ``batch`` slots and a ``cache_len``-deep cache; ``sampler(logits)
    -> [B]`` tokens (greedy by default)."""

    def __init__(self, model, batch: int, cache_len: int,
                 sampler: Optional[Callable] = None):
        from repro_torch.serve.decode import greedy, make_serve_step
        self.model = model
        self.batch, self.cache_len = batch, cache_len
        self.serve_step = make_serve_step(model)
        self.sampler = sampler or greedy
        self.device = model.device
        self.cache = model.init_cache(batch, cache_len)
        self.slots: List[Optional[Request]] = [None] * batch
        # per slot: position and last token; idle slots run a dummy token
        self.pos = np.zeros(batch, np.int64)
        self.last = np.zeros(batch, np.int32)
        self.remaining_prompt: List[deque] = [deque() for _ in range(batch)]
        self.queue: deque = deque()
        self.completed: List[Request] = []
        self.decode_steps = 0            # batched decode steps run

    # -- queue management ------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _fill_slots(self) -> None:
        for b in range(self.batch):
            if self.slots[b] is None and self.queue:
                req = self.queue.popleft()
                self.slots[b] = req
                self.remaining_prompt[b] = deque(req.prompt.tolist())
                # the slot's cache still holds its previous occupant: zero it
                self.cache = _zero_slot(self.cache, b)
                self.pos[b] = 0
                self.last[b] = self.remaining_prompt[b].popleft()

    # -- one engine step ---------------------------------------------------
    def step(self) -> bool:
        """One round: each group of slots at one position runs one batched
        decode step; prefilling slots consume prompt tokens, decoding slots
        sample.  -> False when there was nothing to run."""
        self._fill_slots()
        if all(s is None for s in self.slots):
            return False
        groups: Dict[int, List[int]] = {}
        for b, req in enumerate(self.slots):
            if req is not None:
                groups.setdefault(int(self.pos[b]), []).append(b)
        for pos, bs in sorted(groups.items()):
            # the step runs every row; the other groups' slots keep theirs
            others = [b for p, g in groups.items() if p != pos for b in g]
            held = _take_rows(self.cache, others) if others else None
            toks = torch.from_numpy(self.last[:, None].copy()).to(self.device)
            logits, self.cache = self.serve_step(self.cache, toks, pos)
            self.decode_steps += 1
            if held is not None:
                _put_rows(self.cache, *held)
            nxt = self.sampler(logits).cpu().numpy()
            for b in bs:
                req = self.slots[b]
                self.pos[b] += 1
                if self.remaining_prompt[b]:
                    self.last[b] = self.remaining_prompt[b].popleft()
                else:
                    tok = int(nxt[b])
                    req.out_tokens.append(tok)
                    self.last[b] = tok
                    if ((req.eos_id is not None and tok == req.eos_id)
                            or len(req.out_tokens) >= req.max_new_tokens
                            or self.pos[b] >= self.cache_len - 1):
                        req.done = True
                        self.completed.append(req)
                        self.slots[b] = None
        return True

    def run(self, max_steps: int = 10 ** 6) -> List[Request]:
        steps = 0
        while (self.queue or any(self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return self.completed


def _map_cache(fn, *caches):
    """Apply ``fn`` leaf by leaf to per-layer caches of the same structure
    (lists of ``KVCache``/``MambaCache`` named tuples)."""
    return [type(entries[0])(*(fn(*leaves) for leaves in zip(*entries)))
            for entries in zip(*caches)]


def _zero_slot(cache, b: int):
    """Zero slot ``b``'s rows of every cache leaf ([B, ...]), in place."""
    def zero(leaf):
        leaf[b].zero_()
        return leaf
    return _map_cache(zero, cache)


def _take_rows(cache, rows: List[int]):
    """A copy of slots ``rows`` of every cache leaf ([B, ...]).  -> (the
    row index, the copies)."""
    idx = torch.tensor(rows, device=cache[0][0].device)
    return idx, _map_cache(lambda leaf: leaf.index_select(0, idx), cache)


def _put_rows(cache, idx: torch.Tensor, rows) -> None:
    """Write ``rows`` (from :func:`_take_rows`) back into ``cache`` in place,
    in each leaf's dtype (a step may have promoted a Mamba conv ring)."""
    def put(leaf, held):
        leaf.index_copy_(0, idx, held.to(leaf.dtype))
        return leaf
    _map_cache(put, cache, rows)
