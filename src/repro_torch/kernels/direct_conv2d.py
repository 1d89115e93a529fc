"""Wrappers of the CUDA kernels of the blocked direct convolution, and its
autograd.

``direct_conv2d_blocked`` is the port of the reference's
``direct_conv2d_blocked_pallas`` (``repro/kernels/direct_conv2d.py``):

* under ``torch.no_grad``/``inference_mode``, or when no operand requires
  grad, it runs the fused inference kernel (``_fwd_kernel``, ``:102``):
  ``csrc/direct_conv2d_fwd.cu``'s ``fwd_kernel``, the dense forward tile of
  ``csrc/fwd_tile.cuh`` (a 3xTF32 wgmma implicit GEMM fed by a producer
  warpgroup), or under the ``BF16`` policy its bf16 build
  ``fwd_kernel_bf16`` (bf16 wgmma, f32 sums, bf16 out; the f32 master
  weights cast to bf16 once a call, as the reference casts them), on a
  CUDA tensor, the plain PyTorch version
  (``core.direct_conv.direct_conv_blocked``, its GAP pooled in the
  kernel's own order by ``conv2d_common.gap_replay``) on a CPU tensor;
* with grad mode on and an operand that requires grad it enters
  ``kernels.conv_autograd.BlockedConvFunction``, the counterpart of the
  reference's custom VJP (``_conv``/``_conv_fwd``/``_conv_bwd``,
  ``:655-790``), with the dense family's kernels: the forward kernel with a
  linear epilogue gives the pre-activation ``z``, and the backward runs
  ``direct_conv2d_dgrad`` (``_dgrad_kernel``, ``:138``) and
  ``direct_conv2d_wgrad`` (``_wgrad_kernel``, ``:175``) from
  ``csrc/direct_conv2d_bwd.cu`` with the ``dz = g * act'(z)`` prologue and
  ``db``.

A split sum is summed in the launch that writes its rows: the wgrad's
per-share partial sums by the last CTA of each column of shares, the GAP
rider's per-tile sums by the last CTA of each (image, output block)
(``csrc/split_sum.cuh``; the counters live in ``kernels.split_sum``).  Both
come out bit for bit as ``conv2d_common.wgrad_reduce`` /
``gap_finalize`` of those rows; ``wgrad_partials`` and ``gap_forward``
return the rows beside the sum so that a check can hold them.

Each of the three takes ``stream=``, ``hso=`` and ``machine=``: the dense
family has window kernels (here) and streamed halo-ring kernels
(``kernels.conv2d_stream``, ``csrc/conv2d_stream.cu``), and which one a
direction launches is decided before the launch, by the rules of the
reference's ``_resolve_stream``/``_forward_impl`` (``:232-279``):
``stream=True``/``False`` forces a family, a ``KernelRoute`` pins each
direction, ``hso`` (the streamed strip height) implies the streamed
family, and None asks the blocking models (``core.dispatch.route_stream``:
the window model first).  The training path resolves all three directions
at the forward and carries the ``KernelRoute`` into its backward.

Every wrapper takes its plain version only because the tensor lies on the
CPU; a CUDA tensor launches the kernel or raises.  There is no fallback:
no route switches after a launch fails.  Both forwards (this module's and
the streamed one) build their launch plan (tiles, the C entry's int array)
once per shape (``fwd_launch``).
The wrappers check device, dtype (f32, or under ``BF16`` bf16 operands
with an f32 bias), shapes, contiguity and the 16-byte alignment of
operands read with 16-byte loads.  The training path runs the f32 policy
or ``BF16`` (``training_policy``): under ``BF16`` the forward's bf16 build
with a linear epilogue gives the bf16 ``z``, and the dgrad's and wgrad's
bf16 builds (``dgrad_kernel_bf16``, ``wgrad_kernel_bf16`` on the bf16
namespaces of ``csrc/dgrad_tile.cuh`` and ``csrc/wgrad_tile.cuh``) the
bf16 ``dx`` and the f32 ``dw`` and ``db``, with the reference's cast
discipline (``kernels.conv_autograd``).  A float16 policy raises: no build
reads it.

``LAUNCHES`` counts the kernels launched (a plain integer per kernel, bumped
where the launch happens and nowhere else), so a run can show that it went
through them; ``reset_launches`` sets them to 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.blocking import (FWD_CONSUMERS, FWD_ROWS,
                                       FWD_THREADS, H100_SXM,
                                       WGRAD_MAX_POSITIONS, WGRAD_ROWS,
                                       WGRAD_THREADS, DgradBlocking,
                                       DgradPlan, FwdBlocking, FwdPlan,
                                       MachineModel, WgradBlocking,
                                       WgradPlan, choose_dgrad_blocking,
                                       choose_fwd_blocking,
                                       choose_stream_dgrad_blocking,
                                       choose_stream_fwd_blocking,
                                       choose_stream_wgrad_blocking,
                                       choose_wgrad_blocking, dgrad_plan,
                                       fwd_plan, fwd_smem_bytes, wgrad_plan)
from repro_torch.core.conv2d_common import gap_replay
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.dispatch import (KernelRoute, Stream, resolve_stream,
                                       route_stream)
from repro_torch.core.direct_conv import (backward_spec, conv_spec,
                                          direct_conv_blocked,
                                          direct_conv_dgrad_blocked,
                                          direct_conv_preactivation,
                                          direct_conv_wgrad_blocked)
from repro_torch.core.errors import KernelLaunchError
from repro_torch.core.padding import Padding
from repro_torch.core.precision import BF16, F32, Precision, resolve_precision
from repro_torch.kernels import split_sum
from repro_torch.kernels._build import library
from repro_torch.kernels.conv_autograd import BlockedConvFunction

__all__ = ["LAUNCHES", "reset_launches", "check_machine", "build_dtype",
           "bf16_operands",
           "direct_conv2d_blocked", "FwdLaunch", "fwd_launch", "fwd_plans",
           "gap_forward", "direct_conv2d_dgrad", "dgrad_plans",
           "direct_conv2d_wgrad", "wgrad_partials", "wgrad_plans"]

LAUNCHES = {"direct_conv2d_fwd": 0, "direct_conv2d_fwd_bf16": 0,
            "direct_conv2d_dgrad": 0, "direct_conv2d_dgrad_bf16": 0,
            "direct_conv2d_wgrad": 0, "direct_conv2d_wgrad_bf16": 0}

_ACT_CODES = {None: 0, "linear": 0, "relu": 1, "gelu": 2}
_GRID_YZ_MAX = 65535
# the wgrad tile's compiled limits (wgrad_tile.cuh: threads a CTA, rows of
# an m-tile, positions of a stage), which each wgrad library reports
WGRAD_GEOMETRY = (WGRAD_THREADS, WGRAD_ROWS, WGRAD_MAX_POSITIONS)
# the forward tile's (fwd_tile.cuh: threads of the largest CTA, rows of an
# m-tile, consumer warpgroups), which both forward libraries report
FWD_GEOMETRY = (FWD_THREADS, FWD_ROWS, FWD_CONSUMERS)
# the dense tiles' builds by operand dtype: the forward plan's operand code
# (fwd_tile.cuh kOperandF32, kOperandBf16) and the suffix of the C entries'
# and LAUNCHES keys' names
_FWD_BUILDS = {torch.float32: (0, ""), torch.bfloat16: (1, "_bf16")}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the libraries whose signatures are declared and geometry checked, by name
_DECLARED: dict = {}


def _library(name: str, declare, geometry,
             more_geometries=()) -> ctypes.CDLL:
    """The built library ``name`` with its C signatures declared by
    ``declare(lib, ptr, i32)`` on first use; checks that the geometry it
    was compiled with, ``<name>_geometry``, is ``geometry``, and
    each ``(symbol, geometry)`` of ``more_geometries`` likewise."""
    lib = library(name)
    if _DECLARED.get(name) is lib:
        return lib
    get_geometry = getattr(lib, f"{name}_geometry")
    if get_geometry.argtypes is None:
        i32 = ctypes.c_int
        declare(lib, ctypes.c_void_p, i32)
        lib.cuda_error_name.argtypes = [i32]
        lib.cuda_error_name.restype = ctypes.c_char_p
        for symbol, want in ((f"{name}_geometry", geometry),
                             *more_geometries):
            get = getattr(lib, symbol)
            get.argtypes = [ctypes.POINTER(i32)] * 3
            get.restype = None
            geo = [i32(), i32(), i32()]
            get(*(ctypes.byref(g) for g in geo))
            built = tuple(g.value for g in geo)
            if built != tuple(want):
                raise RuntimeError(f"{name}: {symbol} reports {built}; "
                                   f"the wrapper expects {tuple(want)}")
    _DECLARED[name] = lib
    return lib


def _declare_fwd(lib, ptr, i32) -> None:
    lib.direct_conv2d_fwd.argtypes = [ptr] * 8 + [ctypes.POINTER(i32), ptr]
    lib.direct_conv2d_fwd.restype = i32
    lib.direct_conv2d_fwd_plan.argtypes = [ctypes.POINTER(i32),
                                           ctypes.POINTER(ctypes.c_longlong)]
    lib.direct_conv2d_fwd_plan.restype = i32


def declare_backward(lib, prefix: str, ptr, i32) -> None:
    """Declare the dgrad and wgrad C entries ``<prefix>_dgrad``,
    ``<prefix>_wgrad`` and their ``_plan`` entries, in f32 and in the bf16
    builds (``_bf16`` before ``_plan``), which take the same arguments."""
    for build in ("", "_bf16"):
        entry = getattr(lib, f"{prefix}_dgrad{build}")
        entry.argtypes = [ptr] * 4 + [i32] * 20 + [ptr, ctypes.POINTER(i32)]
        entry.restype = i32
        entry = getattr(lib, f"{prefix}_dgrad{build}_plan")
        entry.argtypes = [i32] * 19 + [ctypes.POINTER(ctypes.c_longlong)]
        entry.restype = i32
        entry = getattr(lib, f"{prefix}_wgrad{build}")
        entry.argtypes = [ptr] * 6 + [ctypes.POINTER(i32), ptr]
        entry.restype = i32
        entry = getattr(lib, f"{prefix}_wgrad{build}_plan")
        entry.argtypes = [i32] * 21 + [ctypes.POINTER(ctypes.c_longlong)]
        entry.restype = i32


def _declare_bwd(lib, ptr, i32) -> None:
    declare_backward(lib, "direct_conv2d", ptr, i32)


def _lib() -> ctypes.CDLL:
    return _library("direct_conv2d_fwd", _declare_fwd, FWD_GEOMETRY)


def _bwd_lib() -> ctypes.CDLL:
    return _library("direct_conv2d_bwd", _declare_bwd, WGRAD_GEOMETRY)


def _check(err: int, lib: ctypes.CDLL, name: str) -> None:
    if err:
        raise KernelLaunchError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.cuda_error_name(err).decode()})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _require(t: Optional[torch.Tensor], name: str, device: torch.device,
             vector_loads: bool = False,
             dtype: torch.dtype = torch.float32) -> Optional[int]:
    """Raise on an operand the kernel cannot take; -> its data pointer
    (None for None), so that a launch checks and reads each operand once.
    ``vector_loads``: the kernel reads it with 16-byte loads, so it must
    start on 16 bytes (a contiguous view at an odd storage offset would
    fault on the card).  ``dtype`` is what the kernel reads: f32, or bf16
    for the dense bf16 builds' operands."""
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != dtype:
        want = "f32" if dtype == torch.float32 else "bf16"
        raise NotImplementedError(
            f"{name} is {t.dtype}: this CUDA kernel takes {want} operands "
            "(the dense forward, dgrad and wgrad take bf16 under the BF16 "
            "policy; the separable kernels are f32 only)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    ptr = t.data_ptr()
    if vector_loads and ptr % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the "
                         "kernel reads it with float4 loads); pass a copy")
    return ptr


# the current device's index without torch.cuda's lazy-init check (the
# public route where a build lacks it)
_CURRENT_DEVICE = getattr(torch._C, "_cuda_getDevice",
                          torch.cuda.current_device)


# the current stream's handle without building a torch.cuda.Stream object
# (what PyTorch's own generated launchers call); the public route where a
# build lacks it
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream, for a C entry point."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(_CURRENT_DEVICE() if device.index is None
                           else device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _by_shapes(check):
    """Cache ``check``, a function of operand shapes and other hashable
    arguments, by its arguments, so that a layer called again pays one
    lookup; arguments that cannot be hashed (a list as padding) run it at
    every call.  An argument that fails a check raises at every call: an
    exception is never cached."""
    cached = functools.lru_cache(maxsize=1024)(check)

    @functools.wraps(check)
    def run(*args):
        try:
            return cached(*args)
        except TypeError:       # unhashable (or the check's own TypeError,
            return check(*args)  # which then raises again)
    return run


def _call(device: torch.device, entry, *args) -> int:
    """Call the C entry point ``entry`` with ``args`` on ``device``'s
    context: directly when it is the current device (the common case, where
    entering ``torch.cuda.device`` costs more than the launch), else inside
    ``torch.cuda.device(device)``."""
    if device.index == _CURRENT_DEVICE():
        return entry(*args)
    with torch.cuda.device(device):
        return entry(*args)


def check_machine(machine: MachineModel) -> None:
    """The kernels are compiled for ``H100_SXM``'s ``threads`` (the
    depthwise kernels' CTA); a machine model may differ from it only in
    ``smem_budget``, ``smem_block``, ``sms`` and ``ctas_per_sm``."""
    if machine.threads != H100_SXM.threads:
        raise ValueError(
            f"machine {machine.name!r}: threads={machine.threads}, but the "
            f"kernels are compiled for {H100_SXM.threads}; only "
            "smem_budget, smem_block, sms and ctas_per_sm may differ")


def _stream_kernels():
    # imported at first use: kernels.conv2d_stream imports this module's
    # launch helpers
    from repro_torch.kernels import conv2d_stream
    return conv2d_stream


def _check_activation(activation: Optional[str]) -> None:
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"have {sorted(k for k in _ACT_CODES if k)}")


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return t.device


def _no_autograd(kernel: str, *ts: Optional[torch.Tensor]) -> None:
    """Raise when grad mode is on and an operand requires grad: ``kernel``
    has no backward yet (the language models' kernels, whose gradients
    come with LM training), and must not return a tensor that silently
    has none."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise NotImplementedError(
            f"{kernel} has no backward kernel yet: training the language "
            "models is the LM-training slice (ROADMAP queue A item 13); call "
            "it under torch.no_grad()")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def direct_conv2d_blocked(x: torch.Tensor, w: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          stride: int = 1, padding: Padding = "VALID",
                          activation: Optional[str] = None,
                          residual: Optional[torch.Tensor] = None,
                          gap: bool = False, precision=F32, *,
                          stream: Stream = None, hso: Optional[int] = None,
                          machine: MachineModel = H100_SXM) -> torch.Tensor:
    """Blocked direct convolution with the fused epilogue, differentiable.

    x: ``[N, Ci/Cib, Hi, Wi, Cib]``; w: ``[Co/Cob, Ci/Cib, Hf, Wf, Cib,
    Cob]``; bias: ``[Co/Cob, Cob]`` or None; residual: ``[N, Co/Cob, Ho,
    Wo, Cob]`` or None, added after the activation -> the output map, or
    with ``gap=True`` the pooled ``[N, Co]`` features.  ``padding`` is
    TF-SAME aware; on CUDA the pads are masked loads, never a padded copy.

    With grad mode on and an operand that requires grad the call goes
    through ``BlockedConvFunction`` (the training path: the f32 policy, or
    ``BF16`` on the bf16 builds of the forward, dgrad and wgrad tiles);
    otherwise it runs the fused inference kernel, under the ``BF16``
    policy its bf16 build (bf16 out, bf16 pooled features).  ``stream``/
    ``hso`` route it between the window and the streamed kernels (module
    docstring); ``machine`` is the model their tiles are fitted to.
    """
    spec = conv_spec(x, w, stride, padding)
    _check_activation(activation)
    check_machine(machine)
    n, coblk, cob = x.shape[0], w.shape[0], w.shape[5]
    if bias is not None and tuple(bias.shape) != (coblk, cob):
        raise ValueError(f"bias shape {tuple(bias.shape)} != {(coblk, cob)}")
    out_shape = (n, coblk, spec.ho, spec.wo, cob)
    if residual is not None and tuple(residual.shape) != out_shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != "
                         f"output shape {out_shape}")
    operands = (x, w, bias, residual)
    op_dtype = resolve_precision(precision).op_dtype
    op_bytes = op_dtype.itemsize
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        policy = training_policy(precision)
        route = _resolve_route(stream, hso, spec, x.shape[4], cob, machine,
                              activation, policy.operand_itemsize)
        family = _Dense(route, machine, hso, policy)
        return BlockedConvFunction.apply(x, w, bias, residual, family, spec,
                                         activation, gap, policy)
    if _routed("fwd", stream, hso, spec, x.shape[4], cob, machine, gap=gap,
               op_bytes=op_bytes):
        return _stream_kernels().stream_forward(
            x, w, bias, stride, padding, activation, residual, gap, hso=hso,
            machine=machine, precision=precision)
    if x.device.type == "cpu":
        # the window model's checks, as on the card; the GAP pooled over its
        # tiles in the kernel's order
        blk = choose_fwd_blocking(n, spec.ho, spec.wo, spec.hf, spec.wf,
                                  spec.stride, spec.ci // x.shape[4],
                                  x.shape[4], coblk, cob, machine, gap,
                                  op_bytes)
        out = direct_conv_blocked(x, w, stride, padding, bias, activation,
                                  precision, residual=residual)
        return gap_replay(out, blk) if gap else out
    return _fwd_cuda(x, w, bias, residual, spec, activation, gap, machine,
                     build_dtype(precision))


def _routed(direction: str, stream: Stream, hso: Optional[int],
            spec: ConvSpec, cib: int, cob: int, machine: MachineModel,
            gap: bool = False, prologue: bool = False,
            op_bytes: int = 4) -> bool:
    """True when this direction launches the streamed kernel."""
    flag = resolve_stream(stream, hso, direction)
    if flag is None:
        flag = route_stream(direction, spec, cib, cob, machine, gap=gap,
                            prologue=prologue, op_bytes=op_bytes)
    return flag


def _resolve_route(stream: Stream, hso: Optional[int], spec: ConvSpec,
                  cib: int, cob: int, machine: MachineModel,
                  activation: Optional[str],
                  op_bytes: int = 4) -> KernelRoute:
    """The training path's route, every direction resolved: an explicit
    bool forces all three, a ``KernelRoute`` pins each, None probes each
    direction's models (at ``op_bytes`` operands) on its own; ``hso`` pins
    the forward only (strip heights are per-kernel model choices)."""
    prologue = activation not in (None, "linear")
    return KernelRoute(**{
        d: _routed(d, stream, hso if d == "fwd" else None, spec, cib, cob,
                   machine, prologue=prologue, op_bytes=op_bytes)
        for d in ("fwd", "dgrad", "wgrad")})


def training_policy(precision) -> Precision:
    """The policy the dense training path runs ``precision`` under: an f32
    operand policy as F32, or ``BF16`` (bf16 operands and saved
    pre-activations on the bf16 builds).  Any other policy raises: no
    backward build reads float16, and a bf16 policy that saves f32
    residuals is not the reference's."""
    policy = resolve_precision(precision)
    if policy.op_dtype == torch.float32:
        return F32
    if policy != BF16:
        raise NotImplementedError(
            f"the dense training path runs the f32 policy and BF16 only; "
            f"got {policy.name}: no CUDA build of the backward reads it")
    return BF16


def build_dtype(precision) -> torch.dtype:
    """The operand dtype of the dense builds (forward, dgrad, wgrad) that
    run ``precision`` on CUDA operands: f32 for the f32 tiles, bf16 for
    their bf16 builds.  Any other operand dtype (float16) raises: no build
    reads it, and none stands in for it at another precision."""
    dtype = resolve_precision(precision).op_dtype
    if dtype not in _FWD_BUILDS:
        raise NotImplementedError(
            f"no CUDA build of the dense kernels reads {dtype} operands: "
            "they run the f32 policy and BF16 (bf16 operands) only")
    return dtype


@dataclasses.dataclass(frozen=True)
class FwdLaunch:
    """What a forward launch at one shape needs but its pointers, stream
    and library, built once (``fwd_launch``): the tiles and the C entry's
    int array (``fwd_tile::Geometry``'s fields, the wgmma width, the
    images, the shared memory and the operand code); ``gap`` whether it
    writes GAP partials; ``dtype`` the operands', the output's and the
    pooled features' (f32: the f32 tile; bf16: its bf16 build)."""
    blk: FwdBlocking
    ints: object
    gap: bool
    dtype: torch.dtype = torch.float32

    @property
    def suffix(self) -> str:
        """The build's suffix to the kernel's ``LAUNCHES`` key."""
        return _FWD_BUILDS[self.dtype][1]


@functools.lru_cache(maxsize=1024)
def fwd_launch(spec: ConvSpec, cib: int, cob: int, act: int, gap: bool,
               streamed: bool, hso: Optional[int] = None,
               machine: MachineModel = H100_SXM,
               blk: Optional[FwdBlocking] = None,
               dtype: torch.dtype = torch.float32) -> FwdLaunch:
    """The plan of a forward launch of geometry ``spec`` on ``cib``/``cob``
    pencils by the build for ``dtype`` operands (``build_dtype``):
    ``blk``, or the window (``streamed``: the streamed) chooser's tiles."""
    code = _FWD_BUILDS[dtype][0]
    op_bytes = dtype.itemsize
    ciblk, coblk = spec.ci // cib, spec.co // cob
    if blk is None:
        args = (spec.n, spec.ho, spec.wo, spec.hf, spec.wf, spec.stride,
                ciblk, cib, coblk, cob, machine, gap)
        blk = (choose_stream_fwd_blocking(*args, hso, op_bytes) if streamed
               else choose_fwd_blocking(*args, op_bytes))
    smem = fwd_smem_bytes(blk.th, blk.tw, spec.hf, spec.wf, spec.stride,
                          blk.chunk, blk.lanes, blk.wgs, gap, op_bytes)
    (pt, _), (pl, _) = spec.pads
    ints = (ciblk, cib, spec.hi, spec.wi, coblk, cob, spec.ho, spec.wo,
            spec.hf, spec.wf, spec.stride, pt, pl, blk.th, blk.tw, blk.wgs,
            blk.strips, blk.nsplit, blk.chunk, act, int(gap), blk.lanes,
            spec.n, smem, code)
    return FwdLaunch(blk=blk, ints=(ctypes.c_int * len(ints))(*ints),
                     gap=gap, dtype=dtype)


def fwd_run(entry, plan: FwdLaunch, x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor], residual: Optional[torch.Tensor],
            spec: ConvSpec):
    """Call a forward kernel's C ``entry`` (the window one or the streamed
    one) with ``plan`` on CUDA operands, each checked and read once ->
    ``(CUDA error code, out, the GAP partials and the pooled [N, Co] they
    sum to, or None and None)``; the caller counts the launch.  A bf16 plan
    casts ``x``, ``w`` and ``residual`` to bf16 (``bf16_operands``: f32
    masters once a call); the bias is f32; ``out`` and the pooled features
    come out at the plan's dtype, the partials f32."""
    dev = _cuda_device(x)
    dt = plan.dtype
    if dt == torch.bfloat16:
        x, w, bias, residual = bf16_operands(x, w, bias, residual)
    ptrs = (_require(x, "x", dev, vector_loads=True, dtype=dt),
            _require(w, "w", dev, vector_loads=True, dtype=dt),
            _require(bias, "bias", dev),
            _require(residual, "residual", dev, dtype=dt))
    blk = plan.blk
    n, coblk, cob = x.shape[0], w.shape[0], w.shape[5]
    if coblk * blk.nsplit > _GRID_YZ_MAX or n > _GRID_YZ_MAX:
        raise ValueError(f"grid too large: Co/Cob={coblk}, N={n}")
    out = torch.empty((n, coblk, spec.ho, spec.wo, cob), device=dev,
                      dtype=dt)
    partials = pooled = counters = None
    stream = _stream(dev)
    if plan.gap:
        partials = torch.empty((n, coblk, blk.tiles, cob), device=dev,
                               dtype=torch.float32)
        pooled = torch.empty((n, coblk * cob), device=dev, dtype=dt)
        counters = split_sum.counters(dev, stream, n * coblk)
    err = _call(dev, entry, *ptrs, out.data_ptr(), _ptr(partials),
                _ptr(pooled), counters, plan.ints, stream)
    return err, out, partials, pooled


def bf16_operands(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor],
                  residual: Optional[torch.Tensor]):
    """The bf16 forwards' operands: x, w and the residual cast to bf16 once
    (the f32 master weights once a call, as the reference's forward casts
    them; no bf16 copy is kept), the bias to f32."""
    bf = torch.bfloat16
    return (x.to(bf), w.to(bf),
            None if bias is None else bias.to(torch.float32),
            None if residual is None else residual.to(bf))


def _fwd_cuda(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
              residual: Optional[torch.Tensor], spec: ConvSpec,
              activation: Optional[str], gap: bool,
              machine: MachineModel = H100_SXM,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the window forward kernel's build for ``dtype`` operands on
    CUDA operands -> the output map, or with ``gap`` the pooled ``[N,
    Co]``."""
    plan = fwd_launch(spec, x.shape[4], w.shape[5], _ACT_CODES[activation],
                      gap, False, None, machine, dtype=dtype)
    lib = _lib()
    name = "direct_conv2d_fwd" + plan.suffix
    err, out, _, pooled = fwd_run(lib.direct_conv2d_fwd, plan, x, w, bias,
                                  residual, spec)
    LAUNCHES[name] += 1
    _check(err, lib, name)
    return pooled if gap else out


def gap_forward(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding: Padding = "VALID", activation: Optional[str] = None,
                residual: Optional[torch.Tensor] = None, *,
                streamed: bool = False, hso: Optional[int] = None,
                machine: MachineModel = H100_SXM, precision=F32,
                with_map: bool = False):
    """One launch of the window forward (``streamed``: the streamed one;
    under ``BF16`` its bf16 build) with the GAP rider on CUDA operands ->
    ``(pooled [N, Co], partials [N, Co/Cob, tiles, Cob])``: the per-tile
    sums the kernel wrote and the pooled features the last CTA of each
    image and output block summed from them, so that a check can hold the
    one against ``conv2d_common.gap_finalize`` of the other; ``with_map``
    appends the stored map and the tiles, which ``conv2d_common
    .gap_replay`` pools to the same bits."""
    spec = conv_spec(x, w, stride, padding)
    _check_activation(activation)
    check_machine(machine)
    _cuda_device(x)
    plan = fwd_launch(spec, x.shape[4], w.shape[5], _ACT_CODES[activation],
                      True, streamed, hso, machine,
                      dtype=build_dtype(precision))
    if streamed:
        family = _stream_kernels()
        lib, counts, name = family._lib(), family.LAUNCHES, "conv2d_stream_fwd"
        entry = lib.conv2d_stream_conv
    else:
        lib, counts, name = _lib(), LAUNCHES, "direct_conv2d_fwd"
        entry = lib.direct_conv2d_fwd
    name += plan.suffix
    err, out, partials, pooled = fwd_run(entry, plan, x, w, bias, residual,
                                         spec)
    counts[name] += 1
    _check(err, lib, name)
    if with_map:
        return pooled, partials, out, plan.blk
    return pooled, partials


def fwd_plans(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              padding: Padding = "VALID", gap: bool = False, *,
              streamed: bool = False, hso: Optional[int] = None,
              machine: MachineModel = H100_SXM,
              dtype: torch.dtype = torch.float32) -> Tuple[FwdPlan, FwdPlan]:
    """What one launch of the window forward kernel (with ``streamed``, the
    streamed one) in its build for ``dtype`` operands runs on these
    operands, tiled as its wrapper tiles them: ``(the kernel library's own
    count, its *_plan entry; core.blocking.fwd_plan's)``.  Reads the built
    library; launches nothing."""
    spec = conv_spec(x, w, stride, padding)
    cib, cob = x.shape[4], w.shape[5]
    plan = fwd_launch(spec, cib, cob, 0, gap, streamed, hso, machine,
                      dtype=dtype)
    entry = (_stream_kernels()._lib().conv2d_stream_conv_plan if streamed
             else _lib().direct_conv2d_fwd_plan)
    out = (ctypes.c_longlong * 4)()
    if entry(plan.ints, out):
        raise ValueError(f"the forward kernel refuses the tiles {plan.blk}")
    model = fwd_plan(plan.blk, spec.n, spec.ho, spec.wo, spec.hf, spec.wf,
                     spec.stride, spec.ci // cib, cib, spec.co // cob, cob,
                     gap, dtype.itemsize)
    return FwdPlan(*out, products=model.products), model


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _backward_operands(g: torch.Tensor, z: Optional[torch.Tensor],
                       activation: Optional[str]) -> None:
    _check_activation(activation)
    if g.dim() != 5:
        raise ValueError(f"expected a cotangent [N, Co/Cob, Ho, Wo, Cob], got "
                         f"{tuple(g.shape)}")
    if z is None and activation not in (None, "linear"):
        raise ValueError(f"activation {activation!r} needs the saved "
                         "pre-activation z")


def plain_policy(dtype: torch.dtype) -> Optional[Precision]:
    """The policy a backward's plain version casts its operands to: none
    for the f32 build (so that f64 operands stay f64 for gradcheck), BF16
    for the bf16 one."""
    return None if dtype == torch.float32 else BF16


def _suffix(dtype: torch.dtype) -> str:
    """A build's suffix to its C entries and ``LAUNCHES`` keys."""
    return _FWD_BUILDS[dtype][1]


def direct_conv2d_dgrad(g: torch.Tensor, w: torch.Tensor,
                        input_hw: Tuple[int, int], stride: int = 1,
                        padding: Padding = "VALID",
                        z: Optional[torch.Tensor] = None,
                        activation: Optional[str] = None, *,
                        stream: Stream = None, hso: Optional[int] = None,
                        machine: MachineModel = H100_SXM,
                        precision=F32) -> torch.Tensor:
    """Input gradient of ``act(conv(x, w) + b)``: the raw cotangent ``g
    [N, Co/Cob, Ho, Wo, Cob]``, the saved pre-activation ``z`` (same shape;
    None for a linear epilogue) and ``w`` -> ``dx [N, Ci/Cib, Hi, Wi, Cib]``
    at the unpadded ``input_hw``, with ``dz = g * act'(z)`` formed as ``g``
    is staged.  ``stride``/``padding`` are the forward's; ``stream``,
    ``hso`` and ``machine`` route it as the forward.  On CUDA: the
    phase-split tensor-core kernel (``csrc/dgrad_tile.cuh``), all phases in
    one launch, its operands copied by TMA, or by cp.async where Cob is not
    a multiple of 4 (8 in bf16).  Under ``BF16`` its bf16 build
    (``dgrad_kernel_bf16``) on ``g``, ``z`` and ``w`` cast to bf16 (no-ops
    on the training path's bf16 operands): ``dx`` comes out in bf16, each
    f32 sum rounded once, as the reference's ``_dgrad_kernel`` under
    ``BF16``; on the CPU the plain version on the same bf16 operands."""
    _backward_operands(g, z, activation)
    check_machine(machine)
    dtype = build_dtype(precision)
    hi, wi = input_hw
    n, coblk, ho, wo, cob = g.shape
    _, ciblk, hf, wf, cib, _ = w.shape
    spec = backward_spec(n, hi, wi, w.shape, stride, padding, g, z)
    prologue = z is not None and activation not in (None, "linear")
    if _routed("dgrad", stream, hso, spec, cib, cob, machine,
               prologue=prologue, op_bytes=dtype.itemsize):
        return _stream_kernels().stream_dgrad(
            g, w, input_hw, stride, padding, z, activation, hso=hso,
            machine=machine, precision=precision)
    blk = choose_dgrad_blocking(n, hi, wi, hf, wf, stride, ciblk, cib, cob,
                                machine, prologue, dtype.itemsize)
    if g.device.type == "cpu":
        return direct_conv_dgrad_blocked(g, w, input_hw, stride, padding, z,
                                         activation,
                                         precision=plain_policy(dtype))
    name = "direct_conv2d_dgrad" + _suffix(dtype)
    lib = _bwd_lib()
    err, dx, grids = dgrad_launch(getattr(lib, name), blk.th, blk, g, w,
                                  spec, z if prologue else None, activation,
                                  dtype)
    LAUNCHES[name] += grids
    _check(err, lib, name)
    return dx


def dgrad_launch(entry, rows: int, blk: DgradBlocking, g: torch.Tensor,
                 w: torch.Tensor, spec: ConvSpec, z: Optional[torch.Tensor],
                 activation: Optional[str],
                 dtype: torch.dtype = torch.float32):
    """Call a phase-split dgrad kernel's C ``entry`` (the window one, whose
    ``rows`` are the tile's ``th``, or the streamed one, whose ``rows`` are
    a strip's ``hso``; the build for ``dtype`` operands) with the tiles
    ``blk`` on CUDA operands, cast to ``dtype``, ``z`` only with the
    prologue -> ``(CUDA error code, dx at dtype, grids launched)``; the
    caller adds the grids to its launch count."""
    dev = _cuda_device(g)
    g, w = g.to(dtype), w.to(dtype)
    z = None if z is None else z.to(dtype)
    ptrs = (_require(g, "g", dev, vector_loads=True, dtype=dtype),
            _require(z, "z", dev, vector_loads=True, dtype=dtype),
            _require(w, "w", dev, vector_loads=True, dtype=dtype))
    n, coblk, ho, wo, cob = g.shape
    _, ciblk, hf, wf, cib, _ = w.shape
    if ciblk > _GRID_YZ_MAX or n > _GRID_YZ_MAX:
        raise ValueError(f"grid too large: Ci/Cib={ciblk}, N={n}")
    dx = torch.empty((n, ciblk, spec.hi, spec.wi, cib), device=dev,
                     dtype=dtype)
    launches = ctypes.c_int(0)
    err = _call(dev, entry, *ptrs, dx.data_ptr(),
                *_dgrad_ints(rows, blk, g.shape, w.shape, spec),
                _ACT_CODES[activation], _stream(dev), ctypes.byref(launches))
    return err, dx, launches.value


def _dgrad_ints(rows: int, blk: DgradBlocking, g_shape, w_shape,
                spec: ConvSpec) -> tuple:
    """The geometry arguments of a dgrad kernel's C entries."""
    n, coblk, ho, wo, cob = g_shape
    _, ciblk, hf, wf, cib, _ = w_shape
    return (n, coblk, cob, ho, wo, ciblk, cib, spec.hi, spec.wi, hf, wf,
            spec.stride, spec.pads[0][0], spec.pads[1][0], rows, blk.tw,
            blk.wgs, blk.lanes, blk.chunk)


def dgrad_plans(g: torch.Tensor, w: torch.Tensor,
                input_hw: Tuple[int, int], stride: int = 1,
                padding: Padding = "VALID", z: Optional[torch.Tensor] = None,
                activation: Optional[str] = None, *, streamed: bool = False,
                machine: MachineModel = H100_SXM,
                dtype: torch.dtype = torch.float32
                ) -> Tuple[DgradPlan, DgradPlan]:
    """What one launch of the window dgrad kernel (with ``streamed``, the
    streamed one) in its build for ``dtype`` operands runs on these
    operands, tiled as its wrapper tiles them by default: ``(the kernel
    library's own count, its *_plan entry; core.blocking.dgrad_plan's)``.
    Reads the built library; launches nothing."""
    hi, wi = input_hw
    n, coblk, _, _, cob = g.shape
    _, ciblk, hf, wf, cib, _ = w.shape
    spec = backward_spec(n, hi, wi, w.shape, stride, padding, g, z)
    prologue = z is not None and activation not in (None, "linear")
    ob = dtype.itemsize
    if streamed:
        blk = choose_stream_dgrad_blocking(n, hi, wi, hf, wf, stride, ciblk,
                                           cib, cob, machine, prologue, None,
                                           ob)
        lib, prefix, rows = _stream_kernels()._lib(), "conv2d_stream", blk.hso
    else:
        blk = choose_dgrad_blocking(n, hi, wi, hf, wf, stride, ciblk, cib,
                                    cob, machine, prologue, ob)
        lib, prefix, rows = _bwd_lib(), "direct_conv2d", blk.th
    entry = getattr(lib, f"{prefix}_dgrad{_suffix(dtype)}_plan")
    out = (ctypes.c_longlong * 3)()
    if entry(*_dgrad_ints(rows, blk, g.shape, w.shape, spec), out):
        raise ValueError(f"the dgrad kernel refuses the tiles {blk}")
    model = dgrad_plan(blk, n, hi, wi, hf, wf, stride, spec.pads, ciblk, cib,
                       coblk, cob, ob)
    return DgradPlan(*out, products=model.products), model


def direct_conv2d_wgrad(x: torch.Tensor, g: torch.Tensor, hf: int, wf: int,
                        stride: int = 1, padding: Padding = "VALID",
                        z: Optional[torch.Tensor] = None,
                        activation: Optional[str] = None,
                        with_db: bool = False, *, stream: Stream = None,
                        hso: Optional[int] = None,
                        machine: MachineModel = H100_SXM, precision=F32):
    """Weight (and bias) gradient of ``act(conv(x, w) + b)``: the forward's
    unpadded input ``x``, the raw cotangent ``g`` and the saved
    pre-activation ``z`` -> ``(dw [Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob] f32,
    db [Co/Cob, Cob] f32 or None)``.  Under ``BF16`` the bf16 build
    (``wgrad_kernel_bf16``) on ``x``, ``g`` and ``z`` cast to bf16; dw and
    db stay f32, as the reference's ``out_dtype=jnp.float32``.

    On CUDA the tensor-core wgrad kernel (``wgrad_partials``,
    ``csrc/wgrad_tile.cuh``) writes one partial sum per position share into
    a ``[splits, |dw| + |db|]`` f32 workspace (``torch.empty``) and the last
    CTAs of each column of shares add them in split order, in the same
    launch; no sum depends on the order CTAs run in, so two runs give
    identical bits.  ``stream``, ``hso`` and ``machine`` route it as the
    forward."""
    _backward_operands(g, z, activation)
    check_machine(machine)
    ob = build_dtype(precision).itemsize
    n, ciblk, hi, wi, cib = x.shape
    cob = g.shape[4]
    spec = backward_spec(n, hi, wi, (g.shape[1], ciblk, hf, wf, cib, cob),
                         stride, padding, g, z)
    prologue = z is not None and activation not in (None, "linear")
    if _routed("wgrad", stream, hso, spec, cib, cob, machine,
               prologue=prologue, op_bytes=ob):
        return _stream_kernels().stream_wgrad(
            x, g, hf, wf, stride, padding, z, activation, with_db, hso=hso,
            machine=machine, precision=precision)
    if x.device.type == "cpu":
        choose_wgrad_blocking(n, spec.ho, spec.wo, hf, wf, stride, ciblk,
                              cib, g.shape[1], cob, machine, prologue, ob)
        return direct_conv_wgrad_blocked(x, g, hf, wf, stride, padding, z,
                                         activation, with_db,
                                         precision=plain_policy(
                                             build_dtype(precision)))
    _, out = wgrad_partials(x, g, hf, wf, stride, padding, z, activation,
                            with_db, machine, precision)
    return split_wgrad(out, x.shape, g.shape, hf, wf, with_db)


def split_wgrad(out: torch.Tensor, x_shape, g_shape, hf: int, wf: int,
                with_db: bool):
    """The summed workspace row ``[|dw| + |db|]`` -> ``(dw, db or None)``,
    views of it."""
    _, ciblk, _, _, cib = x_shape
    _, coblk, _, _, cob = g_shape
    dw_size = coblk * ciblk * hf * wf * cib * cob
    dw = out[:dw_size].view(coblk, ciblk, hf, wf, cib, cob)
    db = out[dw_size:].view(coblk, cob) if with_db else None
    return dw, db


def wgrad_partials(x: torch.Tensor, g: torch.Tensor, hf: int, wf: int,
                   stride: int = 1, padding: Padding = "VALID",
                   z: Optional[torch.Tensor] = None,
                   activation: Optional[str] = None,
                   with_db: bool = False,
                   machine: MachineModel = H100_SXM, precision=F32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wgrad kernel on CUDA operands (tiles from
    ``choose_wgrad_blocking``; under ``BF16`` its bf16 build) -> ``(ws,
    out)``: the f32 workspace ``[splits, |dw| + |db|]`` of per-share
    partial sums, each row laid out as ``dw`` then ``db``, and ``out [|dw|
    + |db|]``, its rows summed in split order by the last CTA of each
    column of shares."""
    _backward_operands(g, z, activation)
    _cuda_device(x)
    dtype = build_dtype(precision)
    n, ciblk, hi, wi, cib = x.shape
    _, coblk, ho, wo, cob = g.shape
    spec = backward_spec(n, hi, wi, (coblk, ciblk, hf, wf, cib, cob), stride,
                         padding, g, z)
    prologue = z is not None and activation not in (None, "linear")
    blk = choose_wgrad_blocking(n, ho, wo, hf, wf, stride, ciblk, cib, coblk,
                                cob, machine, prologue, dtype.itemsize)
    lib = _bwd_lib()
    name = "direct_conv2d_wgrad" + _suffix(dtype)
    plan = wgrad_launch_plan(blk, x.shape, g.shape, hf, wf, spec,
                             _ACT_CODES[activation], with_db)
    err, ws, out = wgrad_launch(getattr(lib, name), plan, x, g,
                                z if prologue else None, dtype)
    LAUNCHES[name] += 1
    _check(err, lib, name)
    return ws, out


@dataclasses.dataclass(frozen=True)
class WgradLaunch:
    """What a tensor-core wgrad launch at one shape needs but its pointers,
    stream and library, built once (``wgrad_launch_plan``): the tiles, the
    workspace row's floats (``|dw| + |db|``), the split-sum columns and the
    C entry's int array."""
    blk: WgradBlocking
    cols: int
    columns: int
    ints: object


@functools.lru_cache(maxsize=1024)
def wgrad_launch_plan(blk: WgradBlocking, x_shape, g_shape, hf: int, wf: int,
                      spec: ConvSpec, act: int, with_db: bool) -> WgradLaunch:
    """The plan of a wgrad launch with the tiles ``blk`` over operands of
    these shapes (cached: a layer called again builds nothing)."""
    n, ciblk, _, _, cib = x_shape
    _, coblk, _, _, cob = g_shape
    if ciblk > _GRID_YZ_MAX or coblk > _GRID_YZ_MAX:
        raise ValueError(f"grid too large: Ci/Cib={ciblk}, Co/Cob={coblk}")
    ints = (*_wgrad_ints(blk, x_shape, g_shape, hf, wf, spec), act,
            int(with_db))
    return WgradLaunch(
        blk=blk, cols=coblk * ciblk * hf * wf * cib * cob + (
            coblk * cob if with_db else 0),
        columns=blk.groups * ciblk * coblk,
        ints=(ctypes.c_int * len(ints))(*ints))


def wgrad_launch(entry, plan: WgradLaunch, x: torch.Tensor, g: torch.Tensor,
                 z: Optional[torch.Tensor],
                 dtype: torch.dtype = torch.float32):
    """Call a tensor-core wgrad kernel's C ``entry`` (the window one or the
    streamed one, the build for ``dtype`` operands) with ``plan`` on CUDA
    operands, cast to ``dtype``, ``z`` only with the prologue -> ``(CUDA
    error code, f32 workspace, its rows' f32 sum)``; the caller counts the
    launch."""
    dev = _cuda_device(x)
    x, g = x.to(dtype), g.to(dtype)
    z = None if z is None else z.to(dtype)
    ptrs = (_require(x, "x", dev, vector_loads=True, dtype=dtype),
            _require(g, "g", dev, vector_loads=True, dtype=dtype),
            _require(z, "z", dev, vector_loads=True, dtype=dtype))
    ws = torch.empty((plan.blk.splits, plan.cols), device=dev,
                     dtype=torch.float32)
    out = torch.empty((plan.cols,), device=dev, dtype=torch.float32)
    stream = _stream(dev)
    err = _call(dev, entry, *ptrs, ws.data_ptr(), out.data_ptr(),
                split_sum.counters(dev, stream, plan.columns), plan.ints,
                stream)
    return err, ws, out


def _wgrad_ints(blk: WgradBlocking, x_shape, g_shape, hf: int, wf: int,
                spec: ConvSpec) -> tuple:
    """The geometry arguments of a wgrad kernel's C entries."""
    n, ciblk, hi, wi, cib = x_shape
    _, coblk, ho, wo, cob = g_shape
    return (n, ciblk, hi, wi, cib, coblk, cob, ho, wo, hf, wf, spec.stride,
            spec.pads[0][0], spec.pads[1][0], blk.th, blk.tw, blk.wgs,
            blk.mpw, blk.lanes, blk.splits)


def wgrad_plans(x: torch.Tensor, g: torch.Tensor, hf: int, wf: int,
                stride: int = 1, padding: Padding = "VALID",
                z: Optional[torch.Tensor] = None,
                activation: Optional[str] = None, *, streamed: bool = False,
                machine: MachineModel = H100_SXM,
                dtype: torch.dtype = torch.float32
                ) -> Tuple[WgradPlan, WgradPlan]:
    """What one launch of the window wgrad kernel (with ``streamed``, the
    streamed one) in its build for ``dtype`` operands runs on these
    operands, tiled as its wrapper tiles them: ``(the kernel library's own
    count, its *_wgrad_plan entry; core.blocking.wgrad_plan's)``.  Reads
    the built library; launches nothing."""
    n, ciblk, hi, wi, cib = x.shape
    _, coblk, ho, wo, cob = g.shape
    spec = backward_spec(n, hi, wi, (coblk, ciblk, hf, wf, cib, cob), stride,
                         padding, g, z)
    prologue = z is not None and activation not in (None, "linear")
    args = (n, ho, wo, hf, wf, stride, ciblk, cib, coblk, cob, machine,
            prologue)
    if streamed:
        blk = choose_stream_wgrad_blocking(*args, None, dtype.itemsize)
        lib, prefix = _stream_kernels()._lib(), "conv2d_stream"
    else:
        blk = choose_wgrad_blocking(*args, dtype.itemsize)
        lib, prefix = _bwd_lib(), "direct_conv2d"
    entry = getattr(lib, f"{prefix}_wgrad{_suffix(dtype)}_plan")
    out = (ctypes.c_longlong * 4)()
    if entry(*_wgrad_ints(blk, x.shape, g.shape, hf, wf, spec),
             int(prologue), out):
        raise ValueError(f"the wgrad kernel refuses the tiles {blk}")
    model = wgrad_plan(blk, n, ho, wo, hf, wf, stride, ciblk, cib, coblk,
                       cob, prologue)
    return WgradPlan(*out, products=model.products), model


# ---------------------------------------------------------------------------
# autograd: the reference's custom VJP
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Dense:
    """The dense family's kernels for ``BlockedConvFunction``, each
    direction on the kernel its ``route`` resolved (the window kernels
    here, or the streamed ones; ``hso`` pins the streamed forward's
    strips), in the builds of ``policy`` (F32, or ``BF16``: the forward's
    bf16 build with a linear epilogue gives the bf16 ``z``, the dgrad's
    and wgrad's bf16 builds the gradients)."""
    route: KernelRoute
    machine: MachineModel = H100_SXM
    hso: Optional[int] = None
    policy: Precision = F32

    def preactivation(self, x, w, bias, spec: ConvSpec) -> torch.Tensor:
        bf16 = self.policy == BF16
        if self.route.fwd:
            streamed = _stream_kernels()
            streamed.stream_blocking(x, w, spec, False, self.hso,
                                     self.machine,
                                     self.policy.operand_itemsize)
            if x.device.type != "cpu":
                return streamed.stream_forward(
                    x, w, bias, spec.stride, spec.pads, hso=self.hso,
                    machine=self.machine, precision=self.policy)
        if x.device.type == "cpu":
            return direct_conv_preactivation(
                x, w, spec.stride, spec.pads, bias,
                precision=self.policy if bf16 else None)
        return _fwd_cuda(x, w, bias, None, spec, None, False, self.machine,
                         build_dtype(self.policy))

    def dgrad(self, g, w, spec: ConvSpec, z, activation) -> torch.Tensor:
        return direct_conv2d_dgrad(g, w, (spec.hi, spec.wi), spec.stride,
                                   spec.pads, z, activation,
                                   stream=self.route.dgrad,
                                   machine=self.machine,
                                   precision=self.policy)

    def wgrad(self, x, g, spec: ConvSpec, z, activation, with_db: bool):
        return direct_conv2d_wgrad(x, g, spec.hf, spec.wf, spec.stride,
                                   spec.pads, z, activation, with_db,
                                   stream=self.route.wgrad,
                                   machine=self.machine,
                                   precision=self.policy)
