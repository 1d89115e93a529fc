"""``ConvContext``: how to run a conv (not what conv to run), as one value.

The port of ``repro/core/context.py:40-125``.  A frozen, hashable record of
the execution context that every conv entry point accepts (``BlockedConv2D``,
``DepthwiseSeparableBlock``, ``BlockedCNN``, ``ConvServer``,
``make_train_step``).  Each field is None for "defer" to the layer's own
field:

  machine    the ``MachineModel`` the dense family's blocking models fit
             against (None -> the layer's ``machine``).  The kernels are
             compiled for ``H100_SXM``'s threads, lanes and positions, so a
             machine may differ from it only in ``smem_budget``, ``sms`` and
             ``ctas_per_sm``; the dense wrappers raise otherwise.
  stream     window-vs-stream inside the dense family: a bool forces all
             three directions, a ``KernelRoute`` pins each, None lets the
             blocking models decide per direction (``route_stream``).
             Pointwise and depthwise legs ignore it.
  precision  the precision policy (None -> f32; a concrete policy reaches
             every layer).  The CUDA kernels run F32 and ``BF16`` (their
             bf16 builds); a float16 policy raises on the card.

The reference's ``dispatch`` and ``impl`` fields arrive with the measured
dispatcher.  Its ``interpret`` has no counterpart: the tensor's device
picks the plain version (CPU) or the kernel (CUDA).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core.blocking import MachineModel
from repro_torch.core.dispatch import Stream
from repro_torch.core.precision import Precision, resolve_precision

__all__ = ["ConvContext", "as_context"]


@dataclasses.dataclass(frozen=True)
class ConvContext:
    """Frozen and hashable; ``ConvContext()`` changes nothing.  A precision
    name normalizes to its ``Precision``, so two spellings of one context
    compare and hash equal."""

    machine: Optional[MachineModel] = None
    stream: Stream = None
    precision: Union[Precision, str, None] = None

    def __post_init__(self):
        if self.precision is not None and not isinstance(self.precision,
                                                         Precision):
            object.__setattr__(self, "precision",
                               resolve_precision(self.precision))

    def override(self, **fields) -> "ConvContext":
        """A new context with the given non-None fields replaced (None is
        "no opinion" and leaves this context's value)."""
        live = {k: v for k, v in fields.items() if v is not None}
        return dataclasses.replace(self, **live) if live else self

    def resolve_precision_for(self, layer_default) -> Precision:
        return resolve_precision(
            layer_default if self.precision is None else self.precision)

    def resolve_machine_for(self, layer_default: MachineModel
                            ) -> MachineModel:
        return layer_default if self.machine is None else self.machine

    def resolve_stream_for(self, layer_default: Stream) -> Stream:
        return layer_default if self.stream is None else self.stream


_EMPTY = ConvContext()


def as_context(context: Optional[ConvContext]) -> ConvContext:
    """None -> the shared do-nothing context; a context passes through; any
    other value raises ``TypeError`` at the call site."""
    if context is None:
        return _EMPTY
    if not isinstance(context, ConvContext):
        raise TypeError(
            f"context= expects a ConvContext, got {type(context).__name__}")
    return context
