"""Single-device continuous-batching server for a ``BlockedCNN``.

A port of ``ConvServer`` (``repro/launch/conv_serve.py:235-462``) on one
device.  Requests of arbitrary size pad up to their ``(H, W)`` bucket on
admission and run whenever their bucket has filled slots; a partly filled
step pads the batch with zero rows rather than waiting (latency over
occupancy — ``occupancy`` reports the cost of that choice).

Kept: per-request deadlines (expired queued requests complete
``TIMED_OUT`` without occupying a slot), bounded queues that shed as
``REJECTED`` at submit, ``warmup``, ``latencies``, ``occupancy`` and
``health``.  Left out: the reference's retry / circuit-breaker / jnp
demotion ladder — on the card it would be exactly the fallback that hides a
failing kernel, so a kernel error propagates to the caller — and the mesh
and ``shard_map`` data/model sharding.  Both are later slices.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.context import ConvContext, as_context
from repro_torch.core.device import resolve_device
from repro_torch.nn.conv import BlockedCNN
from repro_torch.serve.scheduler import (ConvRequest, Outcome, SlotPool,
                                         SpatialBucketer)

__all__ = ["ConvServer"]


class ConvServer:
    """Continuous-batching front door over one device.

    ``clock`` is injectable: wall time (``time.monotonic``) gives real
    latencies, a deterministic counter makes tests exact.  ``context`` (a
    ``ConvContext``) runs every forward the server makes, warm-up included,
    as it says: ``ConvContext(stream=True)`` serves through the streamed
    kernels.
    """

    def __init__(self, model: BlockedCNN, buckets: Sequence[Tuple[int, int]],
                 batch: int, *, device: Union[str, torch.device] = "cuda",
                 clock=time.monotonic, max_queue: Optional[int] = None,
                 context: Optional[ConvContext] = None):
        self.device = resolve_device(device)
        self.context = as_context(context)
        if model.head.device.type != self.device.type:
            raise ValueError(f"model is on {model.head.device}, the server "
                             f"on {self.device}")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.model = model
        self.batch = int(batch)
        self.bucketer = SpatialBucketer(buckets)
        self.pool = SlotPool(self.bucketer.buckets, self.batch,
                             max_queue=max_queue)
        self.clock = clock
        self.completed: list = []
        self._steps = 0
        # batches: the batched forwards the steps ran
        self._counters = {"submitted": 0, "ok": 0, "shed": 0, "timed_out": 0,
                          "batches": 0}

    def _forward(self, imgs: np.ndarray) -> np.ndarray:
        """A batch of f32 images -> its logits as f32 numpy (bf16 logits of
        a bf16 context widen exactly)."""
        x = torch.from_numpy(imgs).to(self.device, torch.float32)
        with torch.inference_mode():
            logits = self.model(x, context=self.context)
        return logits.to(torch.float32).cpu().numpy()

    def warmup(self):
        """Run every bucket once on a zero batch, so that the first request's
        latency is service time, not the kernel build or the allocator's
        first growth."""
        ci = self.model.in_channels
        for bh, bw in self.bucketer.buckets:
            self._forward(np.zeros((self.batch, bh, bw, ci), np.float32))

    def submit(self, req: ConvRequest, *,
               timeout: Optional[float] = None) -> Outcome:
        """Queue one request; -> PENDING, or REJECTED when its bucket's
        bounded queue is full.  ``timeout`` (seconds on the server clock)
        sets ``req.deadline`` from the submit stamp."""
        h, w = req.image.shape[:2]
        req.bucket = self.bucketer.bucket_for(h, w)
        req.t_submit = self.clock()
        if timeout is not None:
            req.deadline = req.t_submit + timeout
        self._counters["submitted"] += 1
        if not self.pool.enqueue(req):
            req.outcome, req.done, req.t_done = (
                Outcome.REJECTED, True, req.t_submit)
            self._counters["shed"] += 1
            self.completed.append(req)
        return req.outcome

    def _expire(self):
        t = self.clock()
        for r in self.pool.sweep(
                lambda r: r.deadline is not None and r.deadline <= t):
            r.outcome, r.done, r.t_done = Outcome.TIMED_OUT, True, t
            self._counters["timed_out"] += 1
            self.completed.append(r)

    def step(self) -> bool:
        """Expire stale queued requests, admit into free slots, then run one
        batched forward per non-empty bucket.  -> ran anything."""
        self._expire()
        self.pool.admit()
        ran = False
        for bucket in self.bucketer.buckets:
            reqs = self.pool.drain(bucket)
            if not reqs:
                continue
            ran = True
            imgs = np.stack([self.bucketer.pad(r.image, bucket)
                             for r in reqs]).astype(np.float32)
            if len(reqs) < self.batch:      # zero rows up to the batch
                fill = np.zeros((self.batch - len(reqs),) + imgs.shape[1:],
                                np.float32)
                imgs = np.concatenate([imgs, fill])
            logits = self._forward(imgs)
            self._counters["batches"] += 1
            t = self.clock()
            for i, r in enumerate(reqs):
                r.logits, r.t_done, r.done = logits[i], t, True
                r.outcome = Outcome.OK
                self._counters["ok"] += 1
                self.completed.append(r)
        self._steps += 1
        return ran

    def run(self, max_steps: int = 10 ** 6):
        steps = 0
        while self.pool.pending and steps < max_steps:
            self.step()
            steps += 1
        if self.pool.pending:               # expired stragglers at the cap
            self._expire()
        return self.completed

    def occupancy(self, bucket: Optional[Tuple[int, int]] = None) -> float:
        return self.pool.occupancy(bucket)

    def latencies(self, bucket: Optional[Tuple[int, int]] = None
                  ) -> np.ndarray:
        """Latencies of served (OK) requests."""
        return np.array([r.latency for r in self.completed
                         if r.outcome is Outcome.OK
                         and (bucket is None or r.bucket == bucket)],
                        np.float64)

    def health(self) -> dict:
        """Queue and outcome counters plus per-bucket occupancy."""
        c = dict(self._counters)
        sub = max(c["submitted"], 1)
        return {
            **c,
            "steps": self._steps,
            "queue_depth": self.pool.queue_depth,
            "pending": self.pool.pending,
            "shed_rate": c["shed"] / sub,
            "timeout_rate": c["timed_out"] / sub,
            "occupancy": {f"{h}x{w}": self.pool.occupancy((h, w))
                          for h, w in self.bucketer.buckets},
        }
