"""Window-vs-stream routing of the dense conv kernels (the first part of the
port of ``repro/core/dispatch.py``).

The dense family has two kernels per direction: the window kernels
(``csrc/direct_conv2d_{fwd,bwd}.cu``) and the streamed halo-ring kernels
(``csrc/conv2d_stream.cu``).  They compute the same function; which one a
launch takes is decided here, *before* the launch, from the blocking
models alone:

* ``KernelRoute`` holds one flag per direction (True = streamed, False =
  window, None = probe), and ``stream_flag`` reads one direction's flag
  from a bool, None or a ``KernelRoute``, as the reference's
  (``core/dispatch.py:406-429``);
* ``resolve_stream`` adds the wrappers' rules (``_resolve_stream`` and
  ``_forward_impl``, ``kernels/direct_conv2d.py:232-279``): a strip height
  ``hso`` implies the streamed route and cannot combine with
  ``stream=False``; the streamed kernels are dense-only;
* ``route_stream`` is the counterpart of ``route_pallas`` (``:439-475``):
  the window model first, the streamed model when the window misfits, and
  ``SmemMisfitError`` naming both models when neither fits.  It never
  catches a launch error: a launch that fails raises, and no route
  switches after it.

On ``H100_SXM`` the window models fit every conv of VGG-16 and MobileNet
v1 (each window tile shrinks to a position where a streamed band of two
strips would not fit), so the probe sends none of them to the streamed
kernels; the streamed route is reached through ``stream=True``.  ``Impl``,
``DispatchKey``, ``ConvDispatcher`` and ``tune`` are still to be ported.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Union

from repro_torch.core.blocking import (MachineModel, SmemMisfitError,
                                       choose_dgrad_blocking,
                                       choose_fwd_blocking,
                                       choose_stream_dgrad_blocking,
                                       choose_stream_fwd_blocking,
                                       choose_stream_wgrad_blocking,
                                       choose_wgrad_blocking)
from repro_torch.core.convspec import ConvSpec, as_dilation

__all__ = ["Direction", "KernelRoute", "stream_flag", "resolve_stream",
           "route_stream"]

Direction = Literal["fwd", "dgrad", "wgrad"]
DIRECTIONS = ("fwd", "dgrad", "wgrad")


@dataclasses.dataclass(frozen=True)
class KernelRoute:
    """Per-direction window/stream resolution of one dense conv: each field
    True = streamed, False = window, None = probe the models at launch.
    Frozen and hashable, so it rides a ``ConvContext`` and an autograd
    function's saved state."""

    fwd: Optional[bool] = None
    dgrad: Optional[bool] = None
    wgrad: Optional[bool] = None

    def get(self, direction: Direction) -> Optional[bool]:
        if direction not in DIRECTIONS:
            raise ValueError(f"unknown direction {direction!r}; have "
                             f"{DIRECTIONS}")
        return getattr(self, direction)


Stream = Union[bool, KernelRoute, None]


def stream_flag(stream: Stream, direction: Direction) -> Optional[bool]:
    """One direction's flag from a bool (all three directions), None (probe
    each) or a ``KernelRoute``."""
    if isinstance(stream, KernelRoute):
        return stream.get(direction)
    return stream


def resolve_stream(stream: Stream, hso: Optional[int], direction: Direction,
                   groups: int = 1, dilation=(1, 1)) -> Optional[bool]:
    """This direction's explicit flag, or None when the models decide.

    ``hso`` (the streamed kernels' strip height) implies the streamed route
    and raises with ``stream=False``; a streamed flag on grouped or dilated
    geometry raises (the streamed kernels are dense-only), and such
    geometry is pinned off the streamed route otherwise."""
    flag = stream_flag(stream, direction)
    if hso is not None:
        if flag is False:
            raise ValueError("hso= is the streamed variant's strip height; "
                             "it cannot combine with stream=False")
        flag = True
    dilation = as_dilation(dilation)
    dense = groups == 1 and dilation == (1, 1)
    if flag and not dense:
        raise ValueError(
            f"the streamed halo-ring kernels are dense-only; got "
            f"groups={groups}, dilation={dilation}")
    return flag if dense else False


def route_stream(direction: Direction, spec: ConvSpec, cib: int, cob: int,
                 machine: MachineModel, gap: bool = False,
                 prologue: bool = False, op_bytes: int = 4) -> bool:
    """Route one dense launch: False when the window model fits, True when
    only the streamed model does; ``SmemMisfitError`` naming both models
    when neither fits.  ``spec`` is the forward's geometry (unpadded input,
    normalized pads); ``gap`` is the forward's fused pooling and
    ``prologue`` the backward's ``act'(z)`` (the dgrads and wgrads stage
    ``z``); ``op_bytes`` the operand size (2: the bf16 builds).  Grouped or
    dilated geometry pins the window path (the streamed kernels are
    dense-only, as the reference's): the forward's window model is asked,
    and so are the dgrad's and the wgrad's, whichever ``direction`` routes,
    so that a layer whose backward cannot fit raises at its forward and not
    at its backward's launch."""
    if direction not in DIRECTIONS:
        raise ValueError(f"unknown direction {direction!r}; have "
                         f"{DIRECTIONS}")
    n, hf, wf, s = spec.n, spec.hf, spec.wf, spec.stride
    ciblk, coblk = spec.ci // cib, spec.co // cob
    if not spec.is_dense:
        if direction == "fwd":
            choose_fwd_blocking(n, spec.ho, spec.wo, hf, wf, s,
                                ciblk // spec.groups, cib, coblk, cob,
                                machine, gap, op_bytes, spec.dilation)
        choose_dgrad_blocking(n, spec.hi, spec.wi, hf, wf, s, ciblk, cib, cob,
                              machine, prologue, op_bytes, spec.dilation)
        choose_wgrad_blocking(n, spec.ho, spec.wo, hf, wf, s, ciblk, cib,
                              coblk, cob, machine, prologue, op_bytes,
                              spec.groups, spec.dilation)
        return False
    if direction == "fwd":
        def window():
            return choose_fwd_blocking(n, spec.ho, spec.wo, hf, wf, s, ciblk,
                                       cib, coblk, cob, machine, gap,
                                       op_bytes)

        def streamed():
            return choose_stream_fwd_blocking(n, spec.ho, spec.wo, hf, wf, s,
                                              ciblk, cib, coblk, cob,
                                              machine, gap, None, op_bytes)
    elif direction == "dgrad":
        def window():
            return choose_dgrad_blocking(n, spec.hi, spec.wi, hf, wf, s,
                                         ciblk, cib, cob, machine, prologue,
                                         op_bytes)

        def streamed():
            return choose_stream_dgrad_blocking(n, spec.hi, spec.wi, hf, wf,
                                                s, ciblk, cib, cob, machine,
                                                prologue, None, op_bytes)
    else:
        def window():
            return choose_wgrad_blocking(n, spec.ho, spec.wo, hf, wf, s,
                                         ciblk, cib, coblk, cob, machine,
                                         prologue, op_bytes)

        def streamed():
            return choose_stream_wgrad_blocking(n, spec.ho, spec.wo, hf, wf,
                                                s, ciblk, cib, coblk, cob,
                                                machine, prologue, None,
                                                op_bytes)
    try:
        window()
        return False
    except SmemMisfitError as window_err:
        try:
            streamed()
        except SmemMisfitError as stream_err:
            raise SmemMisfitError(
                f"{direction} conv misfits both kernel families on "
                f"{machine.name}: window model: {window_err}; streamed "
                f"model: {stream_err}") from None
        return True
