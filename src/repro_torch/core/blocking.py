"""Analytical blocking models of the direct-conv kernels, fitted to one Hopper CTA.

The reference (``repro/core/blocking.py``) fits a Pallas grid step against
TPU VMEM.  On the H100 the scarce resources of one CTA are different: its
shared memory (up to 227 KB, ``MachineModel.smem_block``, above 48 KB only
after ``cudaFuncSetAttribute``, which the kernels' C entries set), its
registers (a thread of a 512-thread CTA holds at most 128: one consumer's
m64n128 f32 accumulator and its operands), and enough CTAs to fill the
card's 132 SMs.

The dense family's kernels are tensor-core tiles, each chosen by a cost
model of the busiest SM's cycles over the candidates that fit:

* **forward** (``choose_fwd_blocking``, ``choose_stream_fwd_blocking``)
  tiles the dense forward of ``csrc/fwd_tile.cuh``: an implicit GEMM whose
  rows are a tile of output positions of one image in 64-row m-tiles, one
  to three consumer warpgroups a CTA, whose columns are an output block's
  lanes (or half of them), and whose K walks (input block, chunk, tap)
  through a two-stage ring (see its section below);
* **dgrad** (``choose_dgrad_blocking``, ``choose_stream_dgrad_blocking``)
  tiles the phase-split tensor-core dgrad of ``csrc/dgrad_tile.cuh``: dx is
  split by its phase against the stride (``dgrad_phase_axes``), and a CTA
  of one to three warpgroups owns a tile of one phase, 64-row wgmma tiles
  of its positions by all Cib lanes, contracting (reachable tap, Cob) a
  ``chunk`` at a time through a two-stage ring;
* **wgrad** (``choose_wgrad_blocking``, ``choose_stream_wgrad_blocking``)
  tiles the tensor-core wgrad of ``csrc/wgrad_tile.cuh``: an implicit GEMM
  whose rows are the (tap, c) pairs in 64-row m-tiles, whose columns are
  Cob and whose K runs over output positions; a CTA of one to three
  consumer warpgroups shares each staged tile among its m-tiles and walks
  a share of the position tiles, and the shares' partial sums go to a
  workspace whose rows the last CTA of each column of shares sums in split
  order (``SPLIT_SUM_BYTES_PER_CYCLE``: one SM reads a column's rows).

The streamed (halo-ring) kernels of ``csrc/conv2d_stream.cu`` run the same
tiles over bands of strips (their section below).

The separable family has choosers of its own: ``choose_pointwise_blocking``
(the forward's tensor-core tile of ``csrc/conv2d_pointwise.cu``, by a cost
model like the dgrad's; the pointwise dgrad and wgrad are the dense dgrad
and wgrad tiles at 1x1, on their choosers), and for the depthwise FMA
kernels of ``csrc/conv2d_depthwise.cu`` ``choose_depthwise_blocking``,
``choose_depthwise_dgrad_blocking`` (the forward's and the dgrad's items,
walked by a persistent grid) and ``choose_depthwise_wgrad_blocking`` (the
same items over the output, walked in shares of each column).  The
last three fit a CTA of ``MachineModel.threads`` threads in
``smem_budget`` bytes, two CTAs an SM; each sizes its tiles so that the
grid fills the card where the map allows it (``MachineModel.wave``), and
the wgrad splits its position reduction into one wave of CTAs, or one CTA
an SM where a column's rows would pass ``SPLIT_SUM_COLUMN_BYTES``
(``_splits``).

Every chooser is a pure function of its arguments and is cached by them,
so a layer pays for its search once, not at every launch, and every
chooser raises ``SmemMisfitError`` when nothing fits.
"""
from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core.conv2d_common import halo_dims
from repro_torch.core.errors import TransientError
from repro_torch.core.layout import divisors

__all__ = ["SmemMisfitError", "MachineModel", "H100_SXM",
           "FWD_ROWS", "FWD_CONSUMERS", "FWD_THREADS", "FWD_WIDE_CONSUMERS",
           "FWD_K_STEP", "fwd_kpad", "FwdBlocking",
           "NARROW_ROW_VALUES", "NARROW_FWD_CIBS", "NARROW_WGRAD_CIBS",
           "narrow_fits",
           "narrow_chosen", "narrow_rows_a_group",
           "narrow_run_pad", "narrow_groups", "narrow_values",
           "narrow_chunks", "narrow_kpad",
           "narrow_raw_bytes",
           "fwd_reach", "fwd_smem_bytes", "FWD_BF16_CHUNKS", "fwd_bf16_pitch",
           "FwdBf16Layout", "fwd_bf16_layout", "FwdPlan", "fwd_plan",
           "fwd_candidates",
           "choose_fwd_blocking", "dgrad_extents", "dgrad_window",
           "DGRAD_ROWS", "DGRAD_LANES", "DGRAD_CONSUMERS", "PhaseAxis",
           "dgrad_tap_steps", "dgrad_max_taps", "dgrad_reach",
           "dgrad_gathered", "dgrad_rows",
           "dgrad_phase_axes", "dgrad_lanes", "DgradBlocking",
           "dgrad_smem_bytes", "dgrad_bf16_wpitch", "dgrad_bf16_window_bytes",
           "dgrad_bf16_row_bytes", "dgrad_bf16_rings", "dgrad_bf16_smem_bytes",
           "dgrad_tiles", "DgradPlan", "dgrad_plan",
           "dgrad_candidates", "choose_dgrad_blocking",
           "WGRAD_ROWS", "WGRAD_CONSUMERS", "WGRAD_THREADS",
           "WGRAD_MAX_POSITIONS", "WGRAD_MPW", "WGRAD_WORKSPACE_BYTES",
           "SPLIT_SUM_BYTES_PER_CYCLE", "SPLIT_SUM_COLUMN_BYTES",
           "wgrad_lanes", "wgrad_ldx", "wgrad_mtiles", "wgrad_window",
           "wgrad_staged",
           "wgrad_bf16_phases", "wgrad_bf16_wph", "wgrad_bf16_raw_bytes",
           "WgradBlocking",
           "StreamWgradBlocking", "wgrad_smem_bytes", "WgradPlan",
           "wgrad_plan", "wgrad_candidates", "choose_wgrad_blocking",
           "PW_ROWS", "PW_CONSUMERS", "PW_MAX_CHUNK", "PointwiseBlocking",
           "pointwise_smem_bytes", "pointwise_candidates",
           "choose_pointwise_blocking", "pointwise_issued_macs",
           "PointwisePlan", "pointwise_plan", "pointwise_plan_ints",
           "pointwise_bf16_brows", "pointwise_bf16_tma",
           "pointwise_bf16_gap_slots",
           "DW_MAX_TAPS", "DW_THREAD_POSITIONS", "DW_LANE_SPLITS",
           "DW_ITEMS_PER_CTA", "DepthwiseBlocking", "depthwise_fwd_smem_bytes",
           "choose_depthwise_blocking", "depthwise_dgrad_window",
           "depthwise_dgrad_smem_bytes", "depthwise_dgrad_variant",
           "choose_depthwise_dgrad_blocking", "depthwise_dgrad_taps",
           "DepthwiseWgradBlocking",
           "depthwise_wgrad_smem_bytes", "choose_depthwise_wgrad_blocking",
           "depthwise_wgrad_candidates",
           "choose_stream_fwd_blocking", "choose_stream_dgrad_blocking",
           "choose_stream_wgrad_blocking"]


class SmemMisfitError(TransientError, ValueError):
    """A blocking model found no tile that fits one CTA's shared memory (or
    register tile) at the smallest admissible size: the counterpart of the
    reference's ``VmemMisfitError``.  Still a ``ValueError``, so callers
    that caught the old error keep working; a distinct type so that the
    router (``core.dispatch.route_stream``) can tell a capacity misfit,
    which the other kernel family may still serve, from a bad argument."""


@dataclasses.dataclass(frozen=True)
class MachineModel:
    name: str
    # the depthwise FMA kernels: threads per CTA (kThreads), the shared
    # memory one CTA may stage at two CTAs an SM
    threads: int
    smem_budget: int
    sms: int = 132        # streaming multiprocessors
    ctas_per_sm: int = 2  # resident CTAs the FMA kernels' launch bounds ask
    # the most one CTA may use at one CTA an SM (the H100's 227 KB): the
    # tensor-core tiles' budget
    smem_block: int = 232448

    @property
    def wave(self) -> int:
        """CTAs the card holds at once: the grid size that fills it."""
        return self.sms * self.ctas_per_sm


H100_SXM = MachineModel(
    name="h100_sxm", threads=256, smem_budget=96 * 1024, sms=132,
    ctas_per_sm=2)


# ---------------------------------------------------------------------------
# forward: the dense forward tile (csrc/fwd_tile.cuh)
# ---------------------------------------------------------------------------

# An implicit GEMM in 3xTF32 whose rows are a tile of th x tw output
# positions of one image (FWD_ROWS a consumer warpgroup, one to three of
# them: FWD_CONSUMERS), whose columns are an output block's lanes padded to
# a compiled wgmma width (or half of them, `nsplit` 2), and whose K walks
# (input block, chunk of channels, tap) a `chunk` a stage through a
# two-slot ring that a producer warpgroup fills a stage ahead (the weight
# block by TMA, the window by cp.async), writing the weight chunk
# transposed in core-matrix order.  At 128 lanes a CTA has two consumers
# at most (FWD_WIDE_CONSUMERS: a consumer's running sum beside its stage
# accumulator).  The window
# kernel's tile is one m-tile of 64 * wgs rows; the streamed kernel's band
# is `strips = wgs` strips of hso x tw positions, one warpgroup's m-tile
# each, whose rows arrive strip by strip.  The search (`fwd_candidates`)
# weighs each consumer count, tile width and lane split with the largest
# chunk whose shared memory fits one CTA (``machine.smem_block``): the
# busiest SM's CTAs in rounds of the CTAs it holds at once, each CTA's
# stages the longer of the consumers' side (its three-product wgmmas at
# DGRAD_MACS_PER_CYCLE over the share FWD_WG_EFFICIENCY of it that the SM's
# resident consumer warpgroups keep busy, so empty rows cost what full ones
# do, and a warpgroup's A loads and issue per k8 step) and the producer's
# stage (a fixed part, its copies and its weight split a thread), and a
# CTA's prologue and epilogue.  The constants were fitted (least squares on
# the log of the time) to the timings of 441 candidates at VGG-16's 13
# layers, both routes, by `python -m repro_torch.launch.fwd_tiles_ab` on an
# H100 80GB HBM3 at 700 W; they are a fit, not a description of the card
# (two consumer warpgroups then keep the rate no worse than one).
# tests/test_torch_fwd_tiles.py pins the tiles chosen there, so a change
# here that moves one shows.
#
# The bf16 build of the tile (``op_bytes`` 2) is another design
# (``fwd_tile.cuh`` namespace bf16, the dgrad's of ``dgrad_tile.cuh``): both
# wgmma operands from shared memory, the window's cells flattened
# (``fwd_bf16_pitch`` cells a plane row) so that an m-tile is 64 consecutive
# cells and a tap the same descriptor started further on, stride ``s`` staged
# as ``s x s`` phase planes, a window ring and a ring of filter rows' weights
# (``fwd_bf16_layout``), one accumulator and three consumers at every width,
# a persistent grid walking (tile, output block x split, image) items.  Its
# search is ``_fwd_bf16_candidates``, with constants of its own.
FWD_ROWS = 64
FWD_CONSUMERS = 3
FWD_THREADS = 128 * (FWD_CONSUMERS + 1)     # the largest CTA (kMaxThreads)
# at 128 lanes a consumer's running sum and stage accumulator take 96
# registers: two consumers at most (kWideConsumers); the f32 tile only
FWD_WIDE_CONSUMERS = 2
FWD_WG_EFFICIENCY = {1: 1.0, 2: 1.0, 3: 0.47}
FWD_STEP_CYCLES = 180       # a warpgroup's A load, split and issue a k8 step
FWD_STAGE_CYCLES = 5600     # a stage's copy latency past the ring, barriers
FWD_COPY_CYCLES = 200       # one cp.async of a producer thread
FWD_SPLIT_CYCLES = 5.5      # a weight transposed and split into halves
FWD_TILE_CYCLES = 8100      # a CTA's first stage and its epilogue
# the shared memory of one SM (228 KB), which two small CTAs may share
FWD_SM_SMEM = 233472
# the contraction's slice a wgmma step takes, by operand bytes: TF32 k8
# (3xTF32 for f32 operands), bf16 k16
FWD_K_STEP = {4: 8, 2: 16}


def fwd_kpad(cib: int, op_bytes: int = 4) -> int:
    """Cib rounded up to the k-slices of the forward tile's wgmma steps."""
    k = _fwd_k_step(op_bytes)
    return -(-cib // k) * k


def _fwd_k_step(op_bytes: int) -> int:
    try:
        return FWD_K_STEP[op_bytes]
    except KeyError:
        raise ValueError(f"the forward tile takes 4- or 2-byte operands "
                         f"(f32, bf16); got {op_bytes}") from None


@dataclasses.dataclass(frozen=True)
class FwdBlocking:
    """Launch parameters of one dense forward.  A CTA of ``wgs`` consumer
    warpgroups (and a producer) owns ``th x tw`` output positions of one
    image (``tiles`` an image, the map's last ones overhanging it) by
    ``lanes`` output lanes (an output block splits into ``nsplit`` CTAs),
    and contracts ``chunk`` input channels (a power of two) a stage over a
    ``hwin x wwin`` input window.  The window kernel's tile is one m-tile of ``64 * wgs``
    rows (``strips`` 1); the streamed kernel's band ``strips = wgs`` strips
    of ``hso`` rows, one warpgroup's m-tile each."""
    th: int
    tw: int
    wgs: int
    strips: int
    lanes: int
    nsplit: int
    chunk: int
    tiles: int
    hwin: int
    wwin: int
    # m-tile rows from one tile row to the next: 0 where an m-tile's rows
    # are the tile's positions (the f32 tile), else the bf16 build's
    # flattened plane rows (``fwd_bf16_pitch``), whose rows past ``tw`` are
    # computed and not stored
    pitch: int = 0
    # the f32 tile's filter rows a stage where a stage's weights of every
    # tap would not fit (AlexNet's 11x11 conv1); 0: every row, as the bf16
    # build always stages them
    frows: int = 0
    # 1: the bf16 window kernel's narrow rows (``narrow_fits``): a 128-byte
    # operand row an output position and filter-row group, ``pitch`` tw
    narrow: int = 0

    def stage_rows(self, hf: int) -> int:
        """Filter rows a stage of a filter ``hf`` rows tall."""
        return self.frows or hf

    @property
    def hso(self) -> int:
        return self.th // self.strips

    @property
    def mstride(self) -> int:
        """m-tile rows from one consumer's m-tile to the next in the
        streamed band (a strip's), or the window tile's ``64 * wgs``."""
        if self.strips == 1:
            return FWD_ROWS * self.wgs
        return self.hso * (self.pitch or self.tw)


def fwd_reach(f: int, dilation: int) -> int:
    """The rows (columns) a filter of ``f`` taps at ``dilation`` spans:
    its dilated extent ``(f - 1) * dilation + 1``."""
    return (f - 1) * dilation + 1


# The narrow rows (csrc/narrow_rows.cuh), the bf16 window forward's and
# wgrad's path where a filter row's (dw, c) run of ``L = wf * cib`` values
# fits one 128-byte operand row at dilation 1 (Cib 3 at 11x11 and 3x3): the
# producer builds a row an output position and group of ``r`` filter rows
# from the tile's input rows (staged by 16-byte copies into raw rows), run
# k at value ``k * Lp`` (``narrow_run_pad``, whole 16-byte chunks).
NARROW_ROW_VALUES = 64


# The pencil widths at which the choosers take the narrow rows unasked:
# those where they were timed faster than the per-tap tiles (PERF.md), the
# forward at Cib 3 (3x3, 7x7 and 11x11 filters) and Cib 8 (5x5), the wgrad
# at Cib 3 alone (at Cib 8, 5x5, the per-tap wgrad was the faster).  Other
# widths keep their per-tap tiles unless ``narrow=True`` asks.
NARROW_FWD_CIBS = (3, 8)
NARROW_WGRAD_CIBS = (3,)


def narrow_fits(hf: int, wf: int, cib: int, dilation=(1, 1)) -> bool:
    """Whether a conv takes the narrow rows (``narrow_rows::fits``)."""
    return (tuple(dilation) == (1, 1) and hf * wf > 1
            and wf * cib <= NARROW_ROW_VALUES)


def narrow_chosen(hf: int, wf: int, cib: int, dilation=(1, 1),
                  narrow: bool | None = None,
                  widths=NARROW_WGRAD_CIBS) -> bool:
    """Whether a bf16 chooser weighs the narrow rows: where they fit and
    ``narrow`` asks for them, or, ``narrow`` None, at one of its timed
    ``widths`` (``NARROW_FWD_CIBS``, ``NARROW_WGRAD_CIBS``)."""
    return (narrow is not False and narrow_fits(hf, wf, cib, dilation)
            and (bool(narrow) or cib in widths))


def narrow_run_pad(wf: int, cib: int) -> int:
    """``Lp``: a run's place in a row, its ``wf * cib`` values rounded up to
    a 16-byte chunk's 8."""
    return -(-wf * cib // 8) * 8


def narrow_rows_a_group(hf: int, wf: int, cib: int) -> int:
    """``r``: the filter rows (runs) one 128-byte row holds."""
    return min(NARROW_ROW_VALUES // narrow_run_pad(wf, cib), hf)


def narrow_groups(hf: int, wf: int, cib: int) -> int:
    """``G``: the groups of ``r`` filter rows, the wgrad's m-tiles and the
    forward's k16 slice groups."""
    return -(-hf // narrow_rows_a_group(hf, wf, cib))


def narrow_values(hf: int, wf: int, cib: int) -> int:
    """``r * L``: the (tap, c) rows of dw (and w) a group covers."""
    return narrow_rows_a_group(hf, wf, cib) * wf * cib


def narrow_chunks(hf: int, wf: int, cib: int) -> int:
    """The 16-byte chunks of a row that hold values, ``r * Lp / 8``."""
    return narrow_rows_a_group(hf, wf, cib) * narrow_run_pad(wf, cib) // 8


def narrow_kpad(hf: int, wf: int, cib: int) -> int:
    """A group's packed K (``r * Lp``) padded to the forward's k16
    slices."""
    return -(-8 * narrow_chunks(hf, wf, cib) // 16) * 16


def narrow_raw_bytes(rows: int, cib: int, pixels: int) -> int:
    """One raw buffer: ``rows`` rows of ``2 cib pixels`` bytes, a lead and
    the partial chunks at either end (16-byte pitch), then the rows' table
    of three ints each (``narrow_rows::raw_bytes``)."""
    pitch = -(-(2 * cib * pixels + 32) // 16) * 16
    return rows * pitch + -(-12 * rows // 16) * 16


def fwd_smem_bytes(th: int, tw: int, hf: int, wf: int, stride: int,
                   chunk: int, lanes: int, wgs: int,
                   gap: bool = False, op_bytes: int = 4,
                   strips: int = 1, dilation=(1, 1), frows: int = 0,
                   narrow: int = 0, cib: int = 0) -> int:
    """Dynamic shared memory of one forward CTA (``fwd_tile::smem_bytes``,
    ``fwd_tile::bf16::smem_bytes`` for ``op_bytes`` 2).

    f32: 128 bytes to align the base; per slot of the two-slot ring the
    input window (``hwin`` rows of ``wwin`` cells of ``chunk + 4`` floats,
    the columns of each stride phase together, rounded up to 128 bytes)
    and the weight chunk's big and small halves ``[taps * chunk /
    4][lanes][4]``; the raw weight chunk; an int a k8 step (an even count);
    the weights' 8-byte mbarrier; with ``gap`` the consumer warps' ``[4 *
    wgs][lanes]`` f32 sums.  ``frows`` (0: ``hf``) filter rows a stage:
    its taps and the window rows they reach.

    bf16: ``fwd_bf16_layout``'s, ``strips`` the streamed band's strips
    (1: the window kernel).  ``dilation`` ``(dh, dw)`` widens the window to
    the filter's dilated reach (``fwd_reach``); the taps stay ``hf x
    wf``.  ``narrow`` the narrow rows' carve-up, on ``cib`` pencils."""
    if _fwd_k_step(op_bytes) == 16:
        return fwd_bf16_layout(th, tw, hf, wf, stride, chunk, lanes, wgs,
                               strips, gap, dilation=dilation,
                               narrow=narrow, cib=cib).smem
    frows = frows or hf
    hwin = (th - 1) * stride + fwd_reach(frows, dilation[0])
    wwin = (tw - 1) * stride + fwd_reach(wf, dilation[1])
    weights = frows * wf * chunk * lanes
    red = 4 * wgs * lanes if gap else 0
    row = stride * -(-wwin // stride) * (chunk + 4)
    window = -(-hwin * row // 32) * 32
    steps = frows * wf * chunk // 8
    return 128 + 8 + 4 * (2 * (window + 2 * weights) + weights
                          + -(-steps // 2) * 2 + red)


# The bf16 build's shared memory (fwd_tile.cuh, namespace bf16): a window
# slot holds the stage's ``s x s`` phase planes, each ``th + ceil(hf/s) - 1``
# rows of ``fwd_bf16_pitch`` cells of ``2 * chunk`` bytes (one swizzled row),
# whole 128-byte lines, and past the last plane as far as the last
# consumer's 64 rows read at the farthest tap; a weight slot one filter
# row's ``wf`` taps by ``lanes`` by ``chunk``; both in whole 1024 bytes, as
# many weight slots as fit beside two window slots (up to four), then as
# many window slots as fit beside them (up to four).
FWD_BF16_CHUNKS = (64, 32, 16)
FWD_BF16_WINDOWS = 4
FWD_BF16_ROWS = 4
FWD_BF16_BAR_BYTES = 8 * (FWD_BF16_WINDOWS * (2 * FWD_CONSUMERS + 1)
                          + 2 * FWD_BF16_ROWS)
FWD_BF16_ATOM = 1024
# a TMA box's extent along an index, and its element stride, at most
FWD_BF16_BOX = 256
FWD_BF16_MAX_STRIDE = 8


def fwd_bf16_pitch(tw: int, wf: int, stride: int, chunk: int,
                   streamed: bool, dilation: int = 1) -> int:
    """Cells from one plane row to the next in the bf16 build
    (``fwd_tile::bf16::wpitch``): a plane's ``tw + (reach - 1) // stride``
    columns (``reach`` the filter's dilated width, ``fwd_reach``), or in
    the streamed kernel, whose strips' boxes land at each row, that rounded
    up to whole 128 bytes of ``2 * chunk``-byte cells."""
    return dgrad_bf16_wpitch(tw + (fwd_reach(wf, dilation) - 1) // stride,
                             chunk, streamed)


@dataclasses.dataclass(frozen=True)
class FwdBf16Layout:
    """One bf16 forward CTA's shared memory (``fwd_tile::bf16``): the
    plane ``pitch`` and ``plane_cells``, the bytes of a window slot and of
    a weight slot, the ``windows`` and ``rows`` slots of the two rings, and
    ``smem`` in all."""
    pitch: int
    plane_cells: int
    window_bytes: int
    row_bytes: int
    windows: int
    rows: int
    smem: int


def fwd_bf16_layout(th: int, tw: int, hf: int, wf: int, stride: int,
                    chunk: int, lanes: int, wgs: int, strips: int = 1,
                    gap: bool = False,
                    smem_block: int = 232448,
                    dilation=(1, 1), narrow: int = 0,
                    cib: int = 0) -> FwdBf16Layout:
    """The carve-up of one bf16 forward CTA of ``wgs`` consumers (``strips``
    the streamed band's, 1 the window kernel's): a 1024-byte alignment, the
    window and weight slots, the mbarriers, with ``gap`` the consumer warps'
    ``[4 * wgs][lanes]`` f32 sums and a flag (``fwd_tile::bf16::smem_bytes``,
    ``window_slots``, ``row_slots``).  A plane spans the filter's dilated
    reach: ``mh = (reach - 1) // stride + 1`` plane rows of taps.

    ``narrow`` (the window kernel on ``cib`` pencils): a window slot is a
    raw buffer of the tile's input rows (``narrow_raw_bytes``), two or three
    of them (FWD_NARROW_RAW); a weight slot a group's weights
    (``narrow_kpad`` rows of ``lanes``) and its A rows, 128 bytes a
    consumer's 64 positions."""
    atom = FWD_BF16_ATOM
    red = 16 * wgs * lanes + 16 if gap else 0
    room = smem_block - atom - FWD_BF16_BAR_BYTES - red
    if narrow:
        hwin = (th - 1) * stride + hf
        wwin = (tw - 1) * stride + wf
        window = -(-narrow_raw_bytes(hwin, cib, wwin) // atom) * atom
        row = (-(-narrow_kpad(hf, wf, cib) * lanes * 2 // atom) * atom
               + FWD_ROWS * wgs * 128)
        rows = min(FWD_BF16_ROWS, max(room - 2 * window, 0) // row)
        windows = min(FWD_NARROW_RAW, max(room - rows * row, 0) // window)
        return FwdBf16Layout(
            pitch=tw, plane_cells=0, window_bytes=window, row_bytes=row,
            windows=windows, rows=rows,
            smem=atom + windows * window + rows * row + FWD_BF16_BAR_BYTES
            + red)
    streamed = strips > 1
    cb = 2 * chunk
    per = 128 // cb if cb < 128 else 1
    mh = (fwd_reach(hf, dilation[0]) - 1) // stride + 1
    mw = (fwd_reach(wf, dilation[1]) - 1) // stride + 1
    pitch = fwd_bf16_pitch(tw, wf, stride, chunk, streamed, dilation[1])
    plane = -(-(th + mh - 1) * pitch // per) * per
    first = (wgs - 1) * (th // strips * pitch if streamed else FWD_ROWS)
    read = first + FWD_ROWS + (mh - 1) * pitch + mw - 1
    cells = (stride * stride - 1) * plane + max(plane, read)
    window = -(-cells * cb // atom) * atom
    row = -(-wf * lanes * cb // atom) * atom
    rows = min(FWD_BF16_ROWS, max(room - 2 * window, 0) // row)
    windows = min(FWD_BF16_WINDOWS, max(room - rows * row, 0) // window)
    return FwdBf16Layout(
        pitch=pitch, plane_cells=plane, window_bytes=window, row_bytes=row,
        windows=windows, rows=rows,
        smem=atom + windows * window + rows * row + FWD_BF16_BAR_BYTES + red)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """What one forward launch runs (``fwd_tile::plan`` is its C++ twin):
    ``tiles``, an image's tiles; ``function_macs``, positions x taps x Ci
    x Co; ``issued_macs``, the tensor-core MACs: every CTA's (bf16: every
    item's) ``64 * wgs`` rows by ``lanes`` over every tap and Cib padded to
    the k-slices, ``products`` each (three for 3xTF32, one for bf16);
    ``smem``, a CTA's dynamic shared memory; ``window_slots`` and
    ``weight_slots``, its rings' slots (the f32 tile's one ring holds a
    stage's window and weights in each of its two)."""
    tiles: int
    function_macs: int
    issued_macs: int
    smem: int
    window_slots: int = 2
    weight_slots: int = 2
    products: int = 3

    @property
    def padding_share(self) -> float:
        """The share of the issued MACs that are no product of a function
        MAC: m-tile rows past the tile or the map, lanes past Cob, channels
        past Cib."""
        if not self.issued_macs:
            return 0.0
        return 1 - self.products * self.function_macs / self.issued_macs


def fwd_plan(blk: FwdBlocking, n: int, ho: int, wo: int, hf: int, wf: int,
             stride: int, ciblk: int, cib: int, coblk: int, cob: int,
             gap: bool = False, op_bytes: int = 4,
             dilation=(1, 1)) -> FwdPlan:
    """What a launch of the tiles ``blk`` runs over ``n`` images of an ``ho
    x wo`` output, with ``op_bytes`` operands.  ``ciblk`` is the input
    blocks an output block contracts: a grouped conv's ``Cig/Cib``, so the
    MACs are the grouped function's."""
    products = 3 if op_bytes == 4 else 1
    windows = rows = 2
    if products == 1:
        lay = fwd_bf16_layout(blk.th, blk.tw, hf, wf, stride, blk.chunk,
                              blk.lanes, blk.wgs, blk.strips, gap,
                              dilation=dilation, narrow=blk.narrow, cib=cib)
        windows, rows = lay.windows, lay.rows
    # K a tile issues: every tap's Cib padded to the k-slices, or on the
    # narrow rows every group's packed (dh, dw, c) padded to k16
    k = (narrow_groups(hf, wf, cib) * narrow_kpad(hf, wf, cib) if blk.narrow
         else hf * wf * fwd_kpad(cib, op_bytes))
    return FwdPlan(
        tiles=blk.tiles,
        function_macs=n * ho * wo * hf * wf * ciblk * cib * coblk * cob,
        issued_macs=(products * n * blk.tiles * coblk * blk.nsplit * FWD_ROWS
                     * blk.wgs * blk.lanes * k * ciblk),
        smem=fwd_smem_bytes(blk.th, blk.tw, hf, wf, stride, blk.chunk,
                            blk.lanes, blk.wgs, gap, op_bytes, blk.strips,
                            dilation, blk.frows, blk.narrow, cib),
        window_slots=windows, weight_slots=rows, products=products)


def _fwd_shapes(ho: int, wo: int, wgs: int, streamed: bool,
                hso: int | None):
    """The tile shapes the search weighs for ``wgs`` consumers, as ``(th,
    tw)``: for each width, the tallest tile (or band of strips) its m-tiles
    hold, balanced over the map's rows."""
    out = []
    rows = FWD_ROWS * wgs
    for tw in range(1, min(wo, FWD_ROWS if streamed else rows) + 1):
        if streamed:                     # wgs strips of sh rows
            sh = hso if hso is not None else min(-(-ho // wgs),
                                                 FWD_ROWS // tw)
            if sh < 1 or sh * tw > FWD_ROWS:
                continue
            if hso is None:              # balance the bands over the rows
                sh = -(-ho // (wgs * -(-ho // (wgs * sh))))
            out.append((wgs * sh, tw))
        else:
            th = min(ho, rows // tw)
            if th >= 1:
                out.append((-(-ho // -(-ho // th)), tw))
    return out


def fwd_candidates(n: int, ho: int, wo: int, hf: int, wf: int, stride: int,
                   ciblk: int, cib: int, coblk: int, cob: int,
                   machine: MachineModel, gap: bool, streamed: bool,
                   hso: int | None = None, op_bytes: int = 4,
                   dilation=(1, 1), narrow: bool | None = None):
    """The tiles the search weighs, each as ``(key, FwdBlocking)``, the
    least key the choice (see the constants above); ties go to more rows a
    CTA, a larger chunk, fewer splits, fewer tiles, then a smaller
    window.  ``op_bytes`` 2 weighs the bf16 build
    (``_fwd_bf16_candidates``; ``narrow`` as there).  ``ciblk`` is the
    input blocks an output block contracts (a grouped conv's ``Cig/Cib``,
    so the cost counts the grouped MACs); ``dilation`` widens each window
    to the filter's dilated reach."""
    if _fwd_k_step(op_bytes) == 16:
        return _fwd_bf16_candidates(n, ho, wo, hf, wf, stride, ciblk, cib,
                                    coblk, cob, machine, gap, streamed, hso,
                                    dilation, narrow)
    kpad = fwd_kpad(cib)
    # powers of two: a staged cell's copies then divide the producer's 128
    # threads
    chunks = [c for c in (128, 64, 32, 16, 8) if kpad % c == 0]
    # a stage's taps are every filter row's; where no tile fits so (AlexNet's
    # 11x11 conv1), the window kernel's stages take the most rows of a
    # divisor of hf that fits, each within a TMA box of 256 taps
    for frows in [hf] if streamed else [r for r in range(hf, 0, -1)
                                         if hf % r == 0 and r * wf <= 256]:
        out = _fwd_f32_candidates(n, ho, wo, hf, wf, stride, ciblk, cib,
                                  coblk, cob, machine, gap, streamed, hso,
                                  dilation, frows, chunks, kpad)
        if out:
            break
    return out


def _fwd_f32_candidates(n, ho, wo, hf, wf, stride, ciblk, cib, coblk, cob,
                        machine, gap, streamed, hso, dilation, frows, chunks,
                        kpad):
    """``fwd_candidates`` of the f32 tile with ``frows`` filter rows a
    stage."""
    st = frows * wf                     # taps a stage
    out = []
    for wgs in range(2 if streamed else 1, FWD_CONSUMERS + 1):
        rows = FWD_ROWS * wgs
        for th, tw in _fwd_shapes(ho, wo, wgs, streamed, hso):
            if not streamed and th * tw <= FWD_ROWS * (wgs - 1):
                continue                  # a consumer with no row of its own
            hwin = (th - 1) * stride + fwd_reach(hf, dilation[0])
            wwin = (tw - 1) * stride + fwd_reach(wf, dilation[1])
            srows = (th - 1) * stride + fwd_reach(frows, dilation[0])
            tiles = -(-ho // th) * -(-wo // tw)
            for nsplit, lanes in _fwd_splits(cob):
                if lanes == DGRAD_LANES[-1] and wgs > FWD_WIDE_CONSUMERS:
                    continue
                fits = [(c, fwd_smem_bytes(th, tw, hf, wf, stride, c, lanes,
                                           wgs, gap, dilation=dilation,
                                           frows=frows))
                        for c in chunks]
                chunk, smem = next(((c, b) for c, b in fits
                                    if b <= machine.smem_block),
                                   (None, None))
                if chunk is None:
                    continue
                res = 2 if wgs == 1 and 2 * smem <= FWD_SM_SMEM else 1
                ctas = n * tiles * coblk * nsplit
                stages = ciblk * kpad // chunk * (hf // frows)
                mma = (3 * res * rows * st * chunk * lanes
                       / DGRAD_MACS_PER_CYCLE
                       / FWD_WG_EFFICIENCY[min(FWD_CONSUMERS, wgs * res)]
                       + FWD_STEP_CYCLES * st * chunk // 8)
                copies = (srows * wwin * chunk / (4 if cib % 4 == 0 else 1)
                          + st * chunk * lanes / (4 if cob % 4 == 0
                                                  else 1))
                split = FWD_SPLIT_CYCLES * st * chunk * lanes
                other = FWD_STAGE_CYCLES + (
                    FWD_COPY_CYCLES * copies + split) / 128
                rounds = -(-(-(-ctas // machine.sms)) // res)
                cost = rounds * (stages * max(mma, other) + FWD_TILE_CYCLES)
                out.append(((cost, -rows, -chunk, nsplit, tiles,
                             hwin * wwin),
                            FwdBlocking(th=th, tw=tw, wgs=wgs,
                                        strips=wgs if streamed else 1,
                                        lanes=lanes, nsplit=nsplit,
                                        chunk=chunk, tiles=tiles, hwin=hwin,
                                        wwin=wwin,
                                        frows=0 if frows == hf else frows)))
    return out


def _fwd_splits(cob: int):
    """``(nsplit, lanes)``: an output block in one CTA's lanes, or split in
    two, each at the narrowest compiled wgmma width that holds its half."""
    out = []
    for nsplit in (1, 2):
        if nsplit > 1 and cob <= DGRAD_LANES[0]:
            continue
        lanes = next((n_ for n_ in DGRAD_LANES if -(-cob // nsplit) <= n_),
                     None)
        if lanes is not None and (nsplit - 1) * lanes < cob:
            out.append((nsplit, lanes))
    return out


# The bf16 build's search (``_fwd_bf16_candidates``): for each consumer
# count (1-3 at every width; the streamed band's strips 2-3), chunk (64, 32
# or 16 dividing Cib padded to 16) and tile width, the tallest tile its
# m-tiles hold in flattened plane rows (the window tile: ``(th - 1) * pitch
# + tw <= 64 * wgs``; a streamed strip: ``(hso - 1) * pitch + tw <= 64``),
# balanced over the map's rows, with both rings of two slots or more, each
# lane split.  The cost, per SM in cycles: the busiest SM's share of the
# items (the persistent grid walks them in rounds of the card's SMs) of
# ``stages`` stages each, a stage the longer of the consumers' wgmmas (every
# m-tile row, halo columns and rows past the tile included, at
# FWD_BF16_MACS_PER_CYCLE, the share FWD_BF16_WG_EFFICIENCY of it one to
# three consumers keep busy) and the producer's copies (a fixed latency
# shared by the slots in flight, the bytes landed at
# FWD_BF16_BYTES_PER_CYCLE, a cost a TMA box, and where a pencil takes no
# TMA a cost a producer thread's copy), and an item's epilogue; ties go to
# fewer bytes staged a position, then more positions a CTA.  The constants
# were fitted (a random search, the worst route's chosen-over-fastest sum
# the objective) to the card's times of the 884 candidates that
# ``python -m repro_torch.launch.fwd_tiles_ab --dtype bf16 --mobilenet``
# timed at VGG-16's 13 layers and MobileNet's conv1, both routes, in two
# runs on an H100 80GB HBM3 at 700 W (PERF.md); they are a fit, not
# a description of the card.  tests/test_torch_bf16_fwd.py pins the tiles
# chosen there (CHOSEN_BF16_FWD_TILES).
FWD_BF16_MACS_PER_CYCLE = 2048
FWD_BF16_WG_EFFICIENCY = {1: 0.48, 2: 0.93, 3: 1.0}
FWD_BF16_STAGE_CYCLES = 182
FWD_BF16_BYTES_PER_CYCLE = 43
FWD_BF16_BOX_CYCLES = 217
FWD_BF16_COPY_CYCLES = 11
FWD_BF16_TILE_CYCLES = 209


def _fwd_bf16_candidates(n: int, ho: int, wo: int, hf: int, wf: int,
                         stride: int, ciblk: int, cib: int, coblk: int,
                         cob: int, machine: MachineModel, gap: bool,
                         streamed: bool, hso: int | None, dilation=(1, 1),
                         narrow: bool | None = None):
    """``fwd_candidates`` of the bf16 build (see the constants above), each
    tile's ``pitch`` its flattened plane rows'; the same rules as the
    kernels' ``fwd_tile::bf16::valid``.  Where the narrow rows fit the
    window kernel at Cib 3 or 8 (``narrow_chosen``, Cob a multiple of 8,
    a tile of 16 lanes or more) their tiles alone
    (``_fwd_narrow_candidates``; timed faster than the per-tap tiles at
    each of the three nets' first layers and at Cib 8 5x5, PERF.md), else
    the per-tap tiles; ``narrow`` True or False asks for one path's (True:
    the rows at any width they fit)."""
    fits = (not streamed and narrow_chosen(hf, wf, cib, dilation, narrow,
                                           NARROW_FWD_CIBS)
            and cob % 8 == 0)
    if narrow is not False:
        found = (_fwd_narrow_candidates(n, ho, wo, hf, wf, stride, ciblk,
                                        cib, coblk, cob, machine, gap)
                 if fits else [])
        if narrow or found:
            return found
    if stride > FWD_BF16_MAX_STRIDE:
        return []
    kpad = fwd_kpad(cib, 2)
    taps = hf * wf
    mh = (fwd_reach(hf, dilation[0]) - 1) // stride + 1
    planes = stride * stride
    splits = _fwd_splits(cob)
    if all(cob % 8 or cob % min(lanes, 64) for _, lanes in splits):
        # each split lands its weights by copies (Cob 48, 96: no TMA box of
        # whole 64-lane rows): also narrower widths that tile Cob in whole
        # rows, three ways or more (Cob 96 as 3 x 32 lanes)
        splits += [(cob // n_, n_) for n_ in (16, 32, 64)
                   if cob % n_ == 0 and cob // n_ > 2]
    out = []
    for wgs in range(2 if streamed else 1, FWD_CONSUMERS + 1):
        for chunk in (c for c in FWD_BF16_CHUNKS if kpad % c == 0):
            for tw in range(1, min(wo, FWD_ROWS * wgs) + 1):
                pitch = fwd_bf16_pitch(tw, wf, stride, chunk, streamed,
                                       dilation[1])
                if stride * pitch > FWD_BF16_BOX:
                    continue
                if streamed:              # wgs strips of sh rows
                    fit = (FWD_ROWS - tw) // pitch + 1
                    sh = hso if hso is not None else min(-(-ho // wgs), fit)
                    if sh < 1 or tw > FWD_ROWS or sh > fit:
                        continue
                    if hso is None:       # balance the bands over the rows
                        sh = -(-ho // (wgs * -(-ho // (wgs * sh))))
                    th, box = wgs * sh, sh
                else:
                    th = min(ho, (FWD_ROWS * wgs - tw) // pitch + 1)
                    th = -(-ho // -(-ho // th))
                    if (th - 1) * pitch + tw <= FWD_ROWS * (wgs - 1):
                        continue          # a consumer with no row stored
                    sh, box = th, th + mh - 1
                if stride * box > FWD_BF16_BOX:
                    continue
                tiles = -(-ho // th) * -(-wo // tw)
                for nsplit, lanes in splits:
                    lay = fwd_bf16_layout(th, tw, hf, wf, stride, chunk,
                                          lanes, wgs,
                                          wgs if streamed else 1, gap,
                                          machine.smem_block, dilation)
                    if lay.windows < 2 or lay.rows < 2:
                        continue
                    ns = min(lay.windows, lay.rows)
                    mma = (FWD_ROWS * wgs * taps * chunk * lanes
                           / FWD_BF16_MACS_PER_CYCLE
                           / FWD_BF16_WG_EFFICIENCY[wgs])
                    cells = planes * (th + mh - 1) * pitch
                    staged = 2 * chunk * (taps * lanes + cells)
                    copies = 0
                    if cib % 8:           # the window by copies
                        boxes = 0
                        copies += cells * chunk // (2 if cib % 2 == 0
                                                    else 1)
                    else:
                        boxes = planes * (
                            wgs + -(-(sh + mh - 1) // sh) - 1 if streamed
                            else 1)
                    if cob % 8 or cob % min(lanes, 64):
                        # the weights by 2-byte copies
                        copies += taps * lanes * chunk
                    copy = (FWD_BF16_STAGE_CYCLES / (ns - 1)
                            + staged / FWD_BF16_BYTES_PER_CYCLE
                            + FWD_BF16_BOX_CYCLES * boxes
                            + FWD_BF16_COPY_CYCLES * copies / 128)
                    items = n * tiles * coblk * nsplit
                    stages = ciblk * kpad // chunk
                    cost = (-(-items // machine.sms)
                            * (stages * max(mma, copy)
                               + FWD_BF16_TILE_CYCLES))
                    hwin = (th - 1) * stride + fwd_reach(hf, dilation[0])
                    wwin = (tw - 1) * stride + fwd_reach(wf, dilation[1])
                    # ties: fewer bytes staged a position, then more
                    # positions a CTA
                    out.append(((cost, staged * stages / (th * tw),
                                 -th * tw * wgs // (wgs if streamed else 1),
                                 -chunk, nsplit, tiles, hwin * wwin),
                                FwdBlocking(th=th, tw=tw, wgs=wgs,
                                            strips=wgs if streamed else 1,
                                            lanes=lanes, nsplit=nsplit,
                                            chunk=chunk, tiles=tiles,
                                            hwin=hwin, wwin=wwin,
                                            pitch=lay.pitch)))
    return out


# The narrow rows' forward (``_fwd_narrow_candidates``), in cycles of one SM:
# the items in rounds of the card's SMs times the CTAs an SM holds (two
# one-consumer CTAs where their shared memory fits), an item a fixed part
# and, a stage (input block), a part a staged raw row (its copies, its
# clear), a part a filter-row group (its weight box, the slot's handshake)
# and a part a 16-byte chunk of the group's rows a producer thread builds;
# the producer bounds it, the wgmmas hide under it.  Fitted (least squares
# on the card's times) to the narrow tiles ``python -m
# repro_torch.launch.fwd_tiles_ab --first`` timed at AlexNet's conv1,
# VGG-16's conv1_1 and MobileNet's conv1 on an H100 80GB HBM3 at 700 W
# (PERF.md), where it picks the fastest tile timed or one within 1.03 of
# it (1.13 and 1.16 at Cib 3 7x7 stride 2 and Cib 8 5x5, shapes off the
# three nets: it counts the raw rows, not their widths).
FWD_NARROW_ITEM_CYCLES = 2470
FWD_NARROW_ROW_CYCLES = 135
FWD_NARROW_GROUP_CYCLES = 1570
FWD_NARROW_CHUNK_CYCLES = 272
# raw buffers at most: a stage's input rows land two stages ahead
FWD_NARROW_RAW = 3


def _fwd_narrow_candidates(n, ho, wo, hf, wf, stride, ciblk, cib, coblk, cob,
                           machine, gap):
    """The window kernel's narrow-row tiles (``narrow_fits``; the rules of
    ``fwd_tile::bf16::valid`` on ``narrow``): the tile's positions in one
    m-tile of ``64 * wgs`` rows (``pitch`` tw), widths of 16 lanes or more,
    two raw buffers and two weight slots."""
    ng = narrow_groups(hf, wf, cib)
    kp = narrow_kpad(hf, wf, cib)
    nq = narrow_chunks(hf, wf, cib)
    mh = (hf - 1) // stride + 1
    out = []
    for wgs in range(1, FWD_CONSUMERS + 1):
        for th, tw in _fwd_shapes(ho, wo, wgs, False, None):
            if (th * tw <= FWD_ROWS * (wgs - 1) or stride * tw > FWD_BF16_BOX
                    or stride * (th + mh - 1) > FWD_BF16_BOX
                    or stride > FWD_BF16_MAX_STRIDE):
                continue
            hwin = (th - 1) * stride + hf
            wwin = (tw - 1) * stride + wf
            tiles = -(-ho // th) * -(-wo // tw)
            raw = hwin * wwin * cib * 2
            stage = (FWD_NARROW_ROW_CYCLES * hwin
                     + ng * (FWD_NARROW_GROUP_CYCLES + FWD_NARROW_CHUNK_CYCLES
                             * th * tw * nq / 128))
            for nsplit, lanes in _fwd_splits(cob):
                if lanes < 16:
                    continue
                lay = fwd_bf16_layout(th, tw, hf, wf, stride, 16, lanes, wgs,
                                      1, gap, machine.smem_block,
                                      narrow=1, cib=cib)
                if lay.windows < 2 or lay.rows < 2:
                    continue
                res = 2 if wgs == 1 and 2 * lay.smem <= FWD_SM_SMEM else 1
                items = n * tiles * coblk * nsplit
                cost = (-(-items // (machine.sms * res))
                        * (FWD_NARROW_ITEM_CYCLES + ciblk * stage))
                out.append(((cost, raw / (th * tw), -th * tw * wgs, -16,
                             nsplit, tiles, hwin * wwin),
                            FwdBlocking(th=th, tw=tw, wgs=wgs, strips=1,
                                        lanes=lanes, nsplit=nsplit, chunk=16,
                                        tiles=tiles, hwin=hwin, wwin=wwin,
                                        pitch=tw, narrow=1)))
    return out


def _fwd_blocking(n: int, ho: int, wo: int, hf: int, wf: int, stride: int,
                  ciblk: int, cib: int, coblk: int, cob: int,
                  machine: MachineModel, gap: bool, streamed: bool,
                  hso: int | None, what: str,
                  op_bytes: int = 4, dilation=(1, 1)) -> FwdBlocking:
    """The least-cost tile of ``fwd_candidates``."""
    if ho <= 0 or wo <= 0 or n <= 0:
        raise ValueError(f"empty forward: n={n}, output {ho}x{wo}")
    found = fwd_candidates(n, ho, wo, hf, wf, stride, ciblk, cib, coblk,
                           cob, machine, gap, streamed, hso, op_bytes,
                           tuple(dilation))
    if not found:
        raise SmemMisfitError(
            f"no {what} fits the forward (filter {hf}x{wf}, stride {stride},"
            f" dilation {tuple(dilation)}, cib={cib}, cob={cob}): needs more "
            f"than {machine.smem_block} bytes of shared memory even at one "
            "position")
    return min(found, key=lambda kb: kb[0])[1]


@functools.lru_cache(maxsize=4096)
def choose_fwd_blocking(n: int, ho: int, wo: int, hf: int, wf: int,
                        stride: int, ciblk: int, cib: int, coblk: int,
                        cob: int, machine: MachineModel = H100_SXM,
                        gap: bool = False, op_bytes: int = 4,
                        dilation=(1, 1)) -> FwdBlocking:
    """Tile the window forward of ``n`` images into an ``ho x wo`` output
    (``fwd_candidates``): a CTA stages the whole input window of its tile a
    stage; ``cib``/``cob`` are the operands' channel pencils, ``op_bytes``
    their element size (4: the f32 tile, 2: its bf16 build).  A grouped
    conv passes its ``Cig/Cib`` as ``ciblk`` (an output block contracts its
    group's input blocks alone), a dilated one its ``(dh, dw)``: the window
    spans the dilated reach.  The streamed chooser stays dense-only."""
    return _fwd_blocking(n, ho, wo, hf, wf, stride, ciblk, cib, coblk, cob,
                         machine, gap, False, None, "tile", op_bytes,
                         tuple(dilation))


# ---------------------------------------------------------------------------
# input gradient (dgrad)
# ---------------------------------------------------------------------------

def dgrad_extents(ho: int, wo: int, hf: int, wf: int,
                  stride: int = 1, dilation=(1, 1)) -> tuple[int, int]:
    """Rows/cols of the *padded* input that a VALID forward ever read,
    ``E = (out - 1) * stride + (filter - 1) * dilation + 1`` (the dilated
    filter's reach, as the reference's); rows beyond ``E`` have zero
    gradient.  The kernel writes dx at the unpadded shape and gets those
    zeros from its masks; the plain version sizes its buffer with this."""
    return ((ho - 1) * stride + fwd_reach(hf, dilation[0]),
            (wo - 1) * stride + fwd_reach(wf, dilation[1]))


def dgrad_window(hob: int, wob: int, hf: int, wf: int,
                 stride: int) -> tuple[int, int]:
    """Cotangent rows/cols that feed a ``hob x wob`` tile of dx.

    Input row ``i`` takes cotangent rows ``(i + pad - dh) / stride`` for
    the taps ``dh`` that divide exactly, so a tile spans ``hob + hf - 1``
    numerators: that many rows at stride 1, and at stride ``s > 1`` at most
    ``(hob + hf - 2) // s + 2`` (the tile's phase against the stride
    varies)."""
    extra = 1 if stride == 1 else 2
    return ((hob + hf - 2) // stride + extra,
            (wob + wf - 2) // stride + extra)


# The phase-split tensor-core dgrad (csrc/dgrad_tile.cuh).  dx rows with
# (i + pad) % s == ph take exactly the taps dh = ph + s*t from cotangent row
# q - t (i + pad = s*q + ph), so each phase (ph, pw) is a stride-1
# correlation over the taps it reaches; at dilation d the taps dh with dh*d
# = ph mod s, every s / gcd(d, s)-th from the least one, d / gcd(d, s)
# cotangent rows apart (``dgrad_phase_axes``).  A CTA owns th x tw positions of
# one phase: one to three consumer warpgroups (DGRAD_CONSUMERS), each one
# 64-row wgmma tile (DGRAD_ROWS) of positions by the Cib lanes (padded up
# to a compiled width), and a producer warpgroup that stages through TMA;
# per stage they contract `chunk` Cob channels of one Co block over the
# phase's taps, from a window of the cotangent and the weights split in
# TF32 halves.

DGRAD_ROWS = 64                       # rows of one wgmma tile
DGRAD_LANES = (8, 16, 32, 64, 128)    # compiled wgmma widths
DGRAD_CONSUMERS = 3                   # the most consumer warpgroups a CTA
# the bf16 build of the wgrad tile at 128 lanes (of m-tiles, lanes x mpw): a
# consumer's running sum and its stage's accumulator take 128 registers a
# thread, two consumers at most (wgrad_tile::bf16::max_threads)
BF16_WIDE_CONSUMERS = 2
# the bf16 build of the dgrad tile: one accumulator over the contraction, 64
# registers a thread at 128 lanes, three consumers at every width
# (dgrad_tile::bf16::max_threads)
BF16_DGRAD_CONSUMERS = 3
# the cost model of the tile search (``dgrad_candidates``), in cycles of one
# SM: the H100's dense TF32 rate in MACs a cycle (495e12 / 2 / 132 /
# 1.83e9), the share of it one to three consumer warpgroups keep busy, and
# a stage's cycles outside the wgmmas: a fixed part (a copy group's latency,
# the barriers) and per staged float of each of the producer's 128 threads.
# The shares and cycle counts were set by hand while the kernels came up,
# against timings of probe copies that are not kept.  What holds them to
# the card now is ``python -m repro_torch.launch.dgrad_tiles_ab``, which
# times the candidates: on an H100 80GB HBM3 at 700 W the tiles chosen at
# VGG-16's 12 dgrads summed 5.329 ms (window) and 6.602 ms (streamed),
# against 5.177 and 6.487 for the fastest tile measured at each layer.
# tests/test_torch_dgrad_phases.py pins those tiles, so a change here that
# moves one shows.
DGRAD_MACS_PER_CYCLE = 1024
DGRAD_WG_EFFICIENCY = {1: 0.4, 2: 0.55, 3: 0.65}
DGRAD_STAGE_CYCLES = 3000
DGRAD_SPLIT_CYCLES = 2      # a weight split into TF32 halves
DGRAD_PROLOGUE_CYCLES = 2   # dz = g * act'(z)
DGRAD_BOX_CYCLES = 200      # one TMA box of window rows (streamed)


@dataclasses.dataclass(frozen=True)
class PhaseAxis:
    """One axis of a stride phase: the dx rows ``first + s*a`` (``a <
    extent``) take taps ``tap0 + tstep*t`` (``t < taps``) from cotangent
    rows ``q0 + a - qstep*t``; at dilation 1 ``tap0`` is the phase,
    ``tstep`` the stride and ``qstep`` 1."""
    phase: int
    first: int
    extent: int
    q0: int
    taps: int
    tap0: int
    tstep: int
    qstep: int


def dgrad_tap_steps(stride: int, d: int = 1) -> tuple[int, int]:
    """``(tstep, qstep)`` of a phase axis at stride ``s`` and dilation
    ``d``: the taps that reach a phase are ``s / gcd(d, s)`` apart, and
    each reads ``d / gcd(d, s)`` cotangent rows before the one before it
    (``dgrad_tile::tap_step``, ``q_step``)."""
    g = math.gcd(d, stride)
    return stride // g, d // g


def dgrad_max_taps(f: int, stride: int, d: int = 1) -> int:
    """The most taps of a filter ``f`` one phase reaches at stride ``s``
    and dilation ``d`` (phase 0 always reaches tap 0)."""
    return -(-f // dgrad_tap_steps(stride, d)[0])


def dgrad_reach(f: int, stride: int, d: int = 1) -> int:
    """Cotangent rows from a phase row's last tap's read to its first's:
    ``(max taps - 1) * qstep``; a tile of ``th`` phase rows reads ``th +
    reach`` of them."""
    return (dgrad_max_taps(f, stride, d) - 1) * dgrad_tap_steps(stride, d)[1]


def dgrad_gathered(th: int, f: int, stride: int, d: int = 1) -> bool:
    """Whether the f32 dgrad stages only the bands of rows its taps read
    (``dgrad_tile::gather_h``): where the tile's ``th`` rows are fewer than
    the ``qstep`` rows between two taps' reads (never at dilation 1)."""
    return dgrad_max_taps(f, stride, d) > 1 and th < dgrad_tap_steps(
        stride, d)[1]


def dgrad_rows(th: int, f: int, stride: int, d: int = 1) -> int:
    """Rows of the f32 dgrad's staged window (``dgrad_tile::win_rows``): the
    ``th + reach`` rows, or where gathered the taps' bands of ``th``."""
    if dgrad_gathered(th, f, stride, d):
        return dgrad_max_taps(f, stride, d) * th
    return th + dgrad_reach(f, stride, d)


def dgrad_phase_axes(extent: int, f: int, stride: int,
                     pad: int, dilation: int = 1) -> tuple[PhaseAxis, ...]:
    """The ``stride`` phases of one axis of an unpadded input of ``extent``
    rows, filter ``f``, leading pad ``pad``, filter dilation ``dilation``
    (the kernels' ``phase_axis``).  Phase ``ph`` holds the rows with ``(i +
    pad) % s == ph``; the taps ``dh`` that reach it are those with ``dh * d
    = ph (mod s)``: none where ``gcd(d, s)`` does not divide ``ph`` (those
    rows of dx are zeros), else ``tap0 + (s / g) t`` from the least solution
    ``tap0``, tap ``t`` reading cotangent row ``q0 + a - (d / g) t`` with
    ``q0 = (first + pad - tap0 d) / s``, which may be negative."""
    tstep, qstep = dgrad_tap_steps(stride, dilation)
    out = []
    for ph in range(stride):
        first = (ph - pad) % stride
        tap0 = next((k for k in range(tstep)
                     if k * dilation % stride == ph), None)
        taps = (0 if tap0 is None or tap0 >= f
                else (f - 1 - tap0) // tstep + 1)
        tap0 = 0 if tap0 is None else tap0
        out.append(PhaseAxis(
            phase=ph, first=first,
            extent=-(-(extent - first) // stride) if first < extent else 0,
            q0=(first + pad - tap0 * dilation) // stride,
            taps=taps, tap0=tap0, tstep=tstep, qstep=qstep))
    return tuple(out)


def dgrad_lanes(cib: int) -> int:
    """The wgmma width the kernels take for a ``cib`` pencil."""
    lanes = next((n for n in DGRAD_LANES if cib <= n), None)
    if lanes is None:
        raise SmemMisfitError(f"cib={cib} is wider than the dgrad tile's "
                              f"widest wgmma, {DGRAD_LANES[-1]} lanes")
    return lanes


def dgrad_smem_bytes(hf: int, wf: int, stride: int, lanes: int, chunk: int,
                     hwin: int, wwin: int, prologue: bool,
                     streamed: bool = False, dilation=(1, 1)) -> int:
    """Dynamic shared memory of one f32 dgrad CTA
    (``dgrad_tile::smem_bytes``): 128 bytes to align the base; per slot of
    the two-slot ring the weights of the most taps a phase reaches,
    ``chunk x lanes``, and their small halves, and a ``hwin``-row cotangent
    window of ``wwin`` cells of ``chunk + 4`` floats a row (the streamed
    kernel's rows, and a gathered window's (``dgrad_rows``), padded to 128
    bytes, which boxes of several rows need them to be already; the window
    kernel's whole window one box, padded to 128 bytes), with ``z`` beside
    it with the prologue; one int per k8 step of a
    stage (rounded up to an even count); an 8-byte mbarrier per slot and
    copy group; the taps those of a phase at ``dilation``.  The bf16
    build's is ``dgrad_bf16_smem_bytes``."""
    taps = (dgrad_max_taps(hf, stride, dilation[0])
            * dgrad_max_taps(wf, stride, dilation[1]))
    row = wwin * (chunk + 4)
    window = (hwin * -(-row // 32) * 32 if streamed
              else -(-hwin * row // 32) * 32)
    return (128 + 4 * (2 * (2 * taps * chunk * lanes
                            + (2 if prologue else 1) * window)
                       + -(-taps * chunk // 16) * 2)
            + 8 * 2 * DGRAD_CONSUMERS)


@dataclasses.dataclass(frozen=True)
class DgradBlocking:
    """Launch parameters of one dgrad.  A CTA of ``wgs`` consumer
    warpgroups (and a producer) owns ``th x tw`` positions of one phase;
    the window kernel's tile is one m-tile of ``64 * wgs`` rows, the
    streamed kernel's band ``strips = wgs`` strips of ``hso`` rows, one
    warpgroup's 64-row m-tile each, ``mstride`` positions apart.  Its
    columns are the ``lanes`` wgmma width, and a stage contracts ``chunk``
    Cob channels over a ``hwin x wwin`` cotangent window.  In the bf16
    build an m-tile's rows are the window's cells flattened
    (``dgrad_bf16_wpitch`` a window row), so ``mstride`` counts cells:
    ``64 * wgs``, or a strip's ``hso`` window rows."""
    th: int
    tw: int
    strips: int
    wgs: int
    lanes: int
    chunk: int
    mstride: int
    hwin: int
    wwin: int

    @property
    def hso(self) -> int:
        return self.th // self.strips


def dgrad_tiles(blk: DgradBlocking, hi: int, wi: int, hf: int, wf: int,
                stride: int, pads, dilation=(1, 1)
                ) -> list[tuple[PhaseAxis, PhaseAxis, int, int]]:
    """The CTAs of one image and Ci block, in grid order (``tile_of``):
    ``(row axis, column axis, a0, b0)``, phase by phase, row-major; a phase
    that no tap reaches keeps its tiles, which write its zeros."""
    (pt, _), (pl, _) = pads
    rows = dgrad_phase_axes(hi, hf, stride, pt, dilation[0])
    cols = dgrad_phase_axes(wi, wf, stride, pl, dilation[1])
    out = []
    for r in rows:
        for c in cols:
            for a0 in range(0, r.extent, blk.th):
                for b0 in range(0, c.extent, blk.tw):
                    out.append((r, c, a0, b0))
    return out


@dataclasses.dataclass(frozen=True)
class DgradPlan:
    """What one dgrad launch runs (``dgrad_tile::plan`` is its C++ twin):
    ``tiles``, the grid's x extent; ``function_macs``, the function's MACs
    as the phases split them (positions x reachable taps x Cib x Co, over
    the images and Ci blocks); ``issued_macs``, the tensor-core MACs the
    tiles issue: each consumer warpgroup's whole 64-row m-tile over its
    phase's taps, Cob padded to k8 slices in every Co block, the ``lanes``
    width, ``products`` each (three for 3xTF32, one in bf16, where Cob pads
    to k16 slices); ``smem``, a CTA's dynamic shared memory;
    ``window_slots`` and ``weight_slots``, its rings' slots (the f32 tile's
    one ring holds a stage's window and weights in each of its slots)."""
    tiles: int
    function_macs: int
    issued_macs: int
    smem: int
    window_slots: int
    weight_slots: int
    products: int = 3

    @property
    def padding_share(self) -> float:
        """The share of the issued MACs that are no product of a function
        MAC: m-tile rows past the tile or the phase, lanes past Cib,
        channels past Cob."""
        if not self.issued_macs:
            return 0.0
        return 1 - self.products * self.function_macs / self.issued_macs


def dgrad_plan(blk: DgradBlocking, n: int, hi: int, wi: int, hf: int,
               wf: int, stride: int, pads, ciblk: int, cib: int, coblk: int,
               cob: int, op_bytes: int = 4, prologue: bool = False,
               groups: int = 1, dilation=(1, 1)) -> DgradPlan:
    """What a launch of the tiles ``blk`` runs over ``n`` images of an
    unpadded ``hi x wi`` input with leading pads ``pads``, with
    ``op_bytes`` operands, ``z`` staged where ``prologue``; a Ci block of a
    grouped conv contracts its group's ``coblk / groups`` Co blocks alone
    (1 / groups of the dense MACs), and ``dilation`` strides the taps."""
    (pt, _), (pl, _) = pads
    tiles = dgrad_tiles(blk, hi, wi, hf, wf, stride, pads, dilation)
    cells = sum(r.extent * c.extent * r.taps * c.taps
                for r in dgrad_phase_axes(hi, hf, stride, pt, dilation[0])
                for c in dgrad_phase_axes(wi, wf, stride, pl, dilation[1]))
    tile_taps = sum(r.taps * c.taps for r, c, _, _ in tiles)
    kpad = fwd_kpad(cob, op_bytes)
    products = 3 if op_bytes == 4 else 1
    cogblk = coblk // groups
    if op_bytes == 4:
        padded = blk.strips > 1 or dgrad_gathered(blk.th, hf, stride,
                                                  dilation[0])
        smem = dgrad_smem_bytes(hf, wf, stride, blk.lanes, blk.chunk,
                                blk.hwin, blk.wwin, prologue, padded,
                                dilation)
        windows = rows = 2
    else:
        smem = dgrad_bf16_smem_bytes(blk, hf, wf, stride, prologue,
                                     dilation)
        windows, rows = dgrad_bf16_rings(blk, hf, wf, stride, prologue,
                                         dilation=dilation)
    return DgradPlan(
        tiles=len(tiles),
        function_macs=n * ciblk * cells * cib * cogblk * cob,
        issued_macs=(n * ciblk * tile_taps * DGRAD_ROWS * blk.wgs * blk.lanes
                     * cogblk * kpad * products),
        smem=smem, window_slots=windows, weight_slots=rows,
        products=products)


def dgrad_candidates(n: int, hi: int, wi: int, hf: int, wf: int,
                     stride: int, ciblk: int, cib: int, cob: int,
                     machine: MachineModel, prologue: bool, streamed: bool,
                     hso: int | None = None, op_bytes: int = 4,
                     dilation=(1, 1)):
    """The tiles the search weighs, each as ``(key, DgradBlocking)``, the
    least key the choice: for each consumer count (the streamed band's
    strips: two or three, one a warpgroup) and tile width, the tallest
    tile (or strip) that fits its 64-row m-tiles, balanced over the phase's
    rows, and the largest ``chunk`` (a multiple of 8 dividing Cob rounded up
    to 8) whose shared memory fits ``machine.smem_block``.  The key's cost
    estimates the busiest SM's cycles: ``ceil(grid / sms)`` CTAs of
    ``stages`` stages, each the longer of the consumers' three-product
    wgmmas over a phase's taps on average (at ``DGRAD_MACS_PER_CYCLE``, the
    share ``DGRAD_WG_EFFICIENCY`` of it they keep busy) and the rest of a
    stage: a fixed part, the producer's split and prologue, and in the
    streamed kernel its TMA boxes of window rows; ties go to more rows a
    CTA, a larger chunk, then a smaller window.  ``op_bytes`` 2 weighs the
    bf16 build (``_dgrad_bf16_candidates``).  ``dilation`` sets the taps a
    phase reaches and the window's reach (``dgrad_phase_axes``); a grouped
    conv takes the dense tiles (the cost is per Co block: a Ci block's
    contraction is only shorter)."""
    if _fwd_k_step(op_bytes) == 16:
        return _dgrad_bf16_candidates(n, hi, wi, hf, wf, stride, ciblk, cib,
                                      cob, machine, prologue, streamed, hso,
                                      dilation)
    lanes = dgrad_lanes(cib)
    mh = dgrad_max_taps(hf, stride, dilation[0])
    mw = dgrad_max_taps(wf, stride, dilation[1])
    rh, rw = (dgrad_reach(hf, stride, dilation[0]),
              dgrad_reach(wf, stride, dilation[1]))
    hp, wp = -(-hi // stride), -(-wi // stride)
    kpad = fwd_kpad(cob)
    chunks = [c for c in range(kpad, 0, -8) if kpad % c == 0]
    out = []
    counts = range(2, DGRAD_CONSUMERS + 1) if streamed else range(
        1, DGRAD_CONSUMERS + 1)
    # where no tile of the tallest height fits (a dilated filter's window),
    # shorter ones are weighed
    for shorter in (False, True):
        if out or streamed and shorter:
            break
        for wgs in counts:
            rows = DGRAD_ROWS * wgs
            for tw in range(1, min(wp, rows) + 1):
                if streamed:                  # wgs strips of sh rows
                    sh = hso if hso is not None else min(-(-hp // wgs),
                                                         DGRAD_ROWS // tw)
                    if sh < 1 or sh * tw > DGRAD_ROWS:
                        continue
                    if hso is None:           # balance the bands over the rows
                        sh = -(-hp // (wgs * -(-hp // (wgs * sh))))
                    th, mstride = wgs * sh, sh * tw
                else:
                    th = min(hp, rows // tw)
                    if th < 1:
                        continue
                    th = -(-hp // -(-hp // th))
                    mstride = rows
                for th in range(th, 0, -1) if shorter else (th,):
                    hwin = dgrad_rows(th, hf, stride, dilation[0])
                    wwin = tw + rw
                    padded = streamed or dgrad_gathered(th, hf, stride,
                                                        dilation[0])
                    chunk = next((c for c in chunks if dgrad_smem_bytes(
                        hf, wf, stride, lanes, c, hwin, wwin, prologue,
                        padded, dilation) <= machine.smem_block), None)
                    if chunk is not None:
                        break
                if chunk is None:
                    continue
                tiles = stride * stride * -(-hp // th) * -(-wp // tw)
                taps = hf * wf / (stride * stride)    # a phase's, on average
                mma = (3 * rows * taps * chunk * lanes / DGRAD_MACS_PER_CYCLE
                       / DGRAD_WG_EFFICIENCY[wgs])
                cells = hwin * wwin * chunk
                other = DGRAD_STAGE_CYCLES + (
                    DGRAD_SPLIT_CYCLES * taps * chunk * lanes
                    + (DGRAD_PROLOGUE_CYCLES * cells if prologue else 0)
                ) / DGRAD_ROWS / 2
                if streamed:    # its TMA boxes of window rows, g's and z's
                    # a box of sh rows lands on 128 bytes only where a row
                    # fills whole 128-byte lines (wwin cells of chunk + 4 = 4
                    # mod 8 floats: wwin a multiple of 8); else one box a row
                    boxes = (-(-(sh + mh - 1) // sh) + wgs - 1
                             if (tw + mw - 1) % 8 == 0 else hwin)
                    other += DGRAD_BOX_CYCLES * boxes * (2 if prologue else 1)
                cost = (-(-tiles * ciblk * n // machine.sms) * (kpad // chunk)
                        * max(mma, other))
                out.append(((cost, -rows, -chunk, hwin * wwin, tiles),
                            DgradBlocking(
                                th=th, tw=tw, strips=wgs if streamed else 1,
                                wgs=wgs, lanes=lanes, chunk=chunk,
                                mstride=mstride, hwin=hwin, wwin=wwin)))
    return out


# The bf16 build (dgrad_tile.cuh, namespace bf16) reads both wgmma operands
# from shared memory: a window cell (a position's `chunk` channels, 16, 32
# or 64) is one row of the 32-, 64- or 128-byte swizzle, an m-tile is 64
# consecutive cells of the window flattened row-major, `dgrad_bf16_wpitch`
# cells a window row, and a tap is the same descriptor started further on.
# Rows on the window's halo columns are computed and not stored, so a tile
# of th x tw positions takes (th - 1) * wpitch + tw m-tile rows.  A stage
# is a chunk's window, in a ring of 2-4 window slots, and the weights of
# each filter row of its phase in turn, in a ring of 2-4 weight slots
# (`dgrad_bf16_rings`), so that chunk 64 fits at 3x3; one accumulator over
# the contraction, three consumers at every width (BF16_DGRAD_CONSUMERS);
# a persistent grid of CTAs walks the (tile, Ci block, image) items.  The
# chooser takes the longest chunk that fits, and weighs the rest by a cost,
# per SM in cycles, on dz as bf16 training calls it: the busiest SM's items
# of `stages` stages, each the longer of the consumers' wgmmas (every
# m-tile row, at DGRAD_BF16_MACS_PER_CYCLE, the share
# DGRAD_BF16_WG_EFFICIENCY of it one to three consumers keep busy) and the
# stage's copies (a fixed latency shared by the slots in flight, the bytes
# landed at DGRAD_BF16_BYTES_PER_CYCLE, a cost a TMA box), and an item's
# epilogue.  The constants were fitted by hand (a random search) to the
# card's times of the candidates `python -m
# repro_torch.launch.dgrad_tiles_ab --dtype bf16` times at VGG-16's 12
# dgrads (571, both routes) and `python -m
# repro_torch.launch.pointwise_tiles_ab --dtype bf16 --kind dgrad` at
# MobileNet's 9 distinct pointwise legs (231), on an H100 80GB HBM3 at
# 700 W; tests/test_torch_bf16_train.py pins the tiles chosen there
# (CHOSEN_BF16_DGRAD_TILES).
DGRAD_BF16_MACS_PER_CYCLE = 2048
DGRAD_BF16_WG_EFFICIENCY = {1: 0.75, 2: 0.75, 3: 0.8}
DGRAD_BF16_STAGE_CYCLES = 150
DGRAD_BF16_BYTES_PER_CYCLE = 45
DGRAD_BF16_BOX_CYCLES = 370        # one TMA box of window rows
DGRAD_BF16_TILE_CYCLES = 260
DGRAD_BF16_CHUNKS = (64, 32, 16)
DGRAD_BF16_WINDOWS = 4             # window ring slots at most
DGRAD_BF16_ROWS = 4                # weight ring slots at most (filter rows)
DGRAD_BF16_BAR_BYTES = 8 * (DGRAD_BF16_WINDOWS * (2 * DGRAD_CONSUMERS + 1)
                            + 2 * DGRAD_BF16_ROWS)


def dgrad_bf16_wpitch(wwin: int, chunk: int, streamed: bool) -> int:
    """Cells from one window row to the next in the bf16 build
    (``dgrad_tile::bf16::wpitch``): ``wwin``, or in the streamed kernel,
    whose strips' boxes land at each row, rounded up so that a row of
    ``2 * chunk``-byte cells is whole 128 bytes."""
    per = 128 // (2 * chunk) if 2 * chunk < 128 else 1
    return -(-wwin // per) * per if streamed else wwin


def dgrad_bf16_window_bytes(blk: DgradBlocking, hf: int, wf: int,
                            stride: int, prologue: bool,
                            dilation=(1, 1)) -> int:
    """Bytes of one window slot of a bf16 dgrad CTA
    (``dgrad_tile::bf16::window_slot_bytes``): the window's cells as far as
    the last consumer's 64 rows read at the largest tap shift, in whole 1024
    bytes, with ``z``'s beside it with the prologue."""
    rh, rw = (dgrad_reach(hf, stride, dilation[0]),
              dgrad_reach(wf, stride, dilation[1]))
    streamed = blk.strips > 1
    pitch = dgrad_bf16_wpitch(blk.wwin, blk.chunk, streamed)
    last = (blk.wgs - 1) * (blk.mstride if streamed else DGRAD_ROWS)
    cells = max(blk.hwin * pitch, last + DGRAD_ROWS + rh * pitch + rw)
    window = -(-cells * 2 * blk.chunk // 1024) * 1024
    return (2 if prologue else 1) * window


def dgrad_bf16_row_bytes(blk: DgradBlocking, wf: int, stride: int,
                         dilation: int = 1) -> int:
    """Bytes of one weight slot of a bf16 dgrad CTA
    (``dgrad_tile::bf16::row_weight_bytes``): the taps of one filter row of
    a phase, at most, ``lanes`` rows of ``2 * chunk`` bytes a tap, in whole
    1024 bytes."""
    mw = dgrad_max_taps(wf, stride, dilation)
    return -(-mw * blk.lanes * 2 * blk.chunk // 1024) * 1024


def dgrad_bf16_rings(blk: DgradBlocking, hf: int, wf: int, stride: int,
                     prologue: bool, smem_block: int = 232448,
                     dilation=(1, 1)):
    """``(window slots, weight slots)`` of a bf16 dgrad CTA
    (``dgrad_tile::bf16::window_slots``, ``row_slots``): as many weight
    slots as fit in ``smem_block`` beside two window slots, up to
    DGRAD_BF16_ROWS, then as many window slots as fit beside them, up to
    DGRAD_BF16_WINDOWS."""
    win = dgrad_bf16_window_bytes(blk, hf, wf, stride, prologue, dilation)
    row = dgrad_bf16_row_bytes(blk, wf, stride, dilation[1])
    room = smem_block - 1024 - DGRAD_BF16_BAR_BYTES
    rows = min(DGRAD_BF16_ROWS, max(room - 2 * win, 0) // row)
    return min(DGRAD_BF16_WINDOWS, (room - rows * row) // win), rows


def dgrad_bf16_smem_bytes(blk: DgradBlocking, hf: int, wf: int, stride: int,
                          prologue: bool, dilation=(1, 1)) -> int:
    """Dynamic shared memory of one bf16 dgrad CTA
    (``dgrad_tile::bf16::smem_bytes``): 1024 bytes to align the base, the
    window slots and the weight slots (``dgrad_bf16_rings``), the mbarriers
    (full and ready per window slot and copy group, empty per window slot,
    full and empty per weight slot)."""
    windows, rows = dgrad_bf16_rings(blk, hf, wf, stride, prologue,
                                     dilation=dilation)
    return (1024 + windows * dgrad_bf16_window_bytes(blk, hf, wf, stride,
                                                     prologue, dilation)
            + rows * dgrad_bf16_row_bytes(blk, wf, stride, dilation[1])
            + DGRAD_BF16_BAR_BYTES)


def _dgrad_bf16_candidates(n: int, hi: int, wi: int, hf: int, wf: int,
                           stride: int, ciblk: int, cib: int, cob: int,
                           machine: MachineModel, prologue: bool,
                           streamed: bool, hso: int | None, dilation=(1, 1)):
    """``dgrad_candidates`` of the bf16 build: for each consumer count,
    chunk and tile width, the tallest tile (a streamed strip: ``(hso - 1) *
    wpitch + tw <= 64``; the window tile: ``(th - 1) * wpitch + tw <= 64 *
    wgs``) balanced over the phase's rows, where its shared memory fits;
    keyed by the cost above, ties to more positions a CTA, a larger chunk,
    then a smaller window."""
    lanes = dgrad_lanes(cib)
    mh = dgrad_max_taps(hf, stride, dilation[0])
    mw = dgrad_max_taps(wf, stride, dilation[1])
    rh, rw = (dgrad_reach(hf, stride, dilation[0]),
              dgrad_reach(wf, stride, dilation[1]))
    hp, wp = -(-hi // stride), -(-wi // stride)
    kpad = fwd_kpad(cob, 2)
    taps = hf * wf / (stride * stride)        # a phase's, on average
    out = []
    counts = range(2, BF16_DGRAD_CONSUMERS + 1) if streamed else range(
        1, BF16_DGRAD_CONSUMERS + 1)
    for wgs in counts:
        for chunk in (c for c in DGRAD_BF16_CHUNKS if kpad % c == 0):
            for tw in range(1, min(wp, DGRAD_ROWS * wgs) + 1):
                wwin = tw + rw
                pitch = dgrad_bf16_wpitch(wwin, chunk, streamed)
                if streamed:              # wgs strips of sh rows
                    fit = (DGRAD_ROWS - tw) // pitch + 1
                    sh = hso if hso is not None else min(-(-hp // wgs), fit)
                    if sh < 1 or tw > DGRAD_ROWS or sh > fit:
                        continue
                    if hso is None:       # balance the bands over the rows
                        sh = -(-hp // (wgs * -(-hp // (wgs * sh))))
                    th, mstride = wgs * sh, sh * pitch
                else:
                    th = min(hp, (DGRAD_ROWS * wgs - tw) // pitch + 1)
                    th = -(-hp // -(-hp // th))
                    mstride = DGRAD_ROWS * wgs
                    if (th - 1) * pitch + tw <= DGRAD_ROWS * (wgs - 1):
                        continue          # a consumer with no row stored
                hwin = th + rh
                blk = DgradBlocking(th=th, tw=tw,
                                    strips=wgs if streamed else 1, wgs=wgs,
                                    lanes=lanes, chunk=chunk,
                                    mstride=mstride, hwin=hwin, wwin=wwin)
                windows, rows = dgrad_bf16_rings(blk, hf, wf, stride,
                                                 prologue, machine.smem_block,
                                                 dilation)
                if windows < 2 or rows < 2:
                    continue
                ns = min(windows, rows)
                tiles = stride * stride * -(-hp // th) * -(-wp // tw)
                mma = (DGRAD_ROWS * wgs * taps * chunk * lanes
                       / DGRAD_BF16_MACS_PER_CYCLE
                       / DGRAD_BF16_WG_EFFICIENCY[wgs])
                # the bytes a stage lands on dz (the training path: no z)
                staged = 2 * chunk * (mh * mw * lanes + hwin * pitch)
                boxes = (wgs + -(-(th // wgs + mh - 1) // (th // wgs)) - 1
                         if streamed else 1)
                copy = (DGRAD_BF16_STAGE_CYCLES / (ns - 1)
                        + staged / DGRAD_BF16_BYTES_PER_CYCLE
                        + DGRAD_BF16_BOX_CYCLES * boxes)
                stages = kpad // chunk
                cost = (-(-tiles * ciblk * n // machine.sms)
                        * (stages * max(mma, copy) + DGRAD_BF16_TILE_CYCLES))
                out.append(((cost, -th * tw * wgs // blk.strips, -chunk,
                             hwin * wwin, tiles), blk))
    # only the longest chunk that fits: at equal tiles chunk 64 (the
    # 128-byte swizzle, four k16 steps a tap) ran 1.34-1.76x faster than 32,
    # and 16 (one step a tap) about half the rate of the longer ones
    longest = max((b.chunk for _, b in out), default=0)
    return [kb for kb in out if kb[1].chunk == longest]


def _dgrad_blocking(n: int, hi: int, wi: int, hf: int, wf: int, stride: int,
                    ciblk: int, cib: int, cob: int, machine: MachineModel,
                    prologue: bool, streamed: bool, hso: int | None,
                    what: str, op_bytes: int = 4,
                    dilation=(1, 1)) -> DgradBlocking:
    """The least-cost tile of ``dgrad_candidates``."""
    found = dgrad_candidates(n, hi, wi, hf, wf, stride, ciblk, cib, cob,
                             machine, prologue, streamed, hso, op_bytes,
                             dilation)
    if not found:
        if hso is not None and hso > DGRAD_ROWS:
            raise ValueError(f"hso={hso} phase rows do not fit a strip of "
                             f"at most {DGRAD_ROWS} positions")
        raise SmemMisfitError(
            f"no {what} tile fits: filter {hf}x{wf}, stride {stride}, "
            f"dilation {tuple(dilation)}, cib={cib}, cob={cob} need more "
            f"than {machine.smem_block} bytes of shared memory even at one "
            "position")
    return min(found, key=lambda kb: kb[0])[1]


@functools.lru_cache(maxsize=4096)
def choose_dgrad_blocking(n: int, hi: int, wi: int, hf: int, wf: int,
                          stride: int, ciblk: int, cib: int, cob: int,
                          machine: MachineModel = H100_SXM,
                          prologue: bool = False,
                          op_bytes: int = 4,
                          dilation=(1, 1)) -> DgradBlocking:
    """Tile the window dgrad of ``n`` images over an unpadded ``hi x wi``
    input (``_dgrad_blocking``): a CTA stages the whole cotangent window of
    its ``th x tw`` tile a stage, with ``z`` beside it when ``prologue``;
    ``op_bytes`` 2 for the bf16 build; ``dilation`` ``(dh, dw)`` the
    filter's (the window then spans a phase's dilated taps)."""
    return _dgrad_blocking(n, hi, wi, hf, wf, stride, ciblk, cib, cob,
                           machine, prologue, False, None, "dgrad", op_bytes,
                           tuple(dilation))


# ---------------------------------------------------------------------------
# weight gradient (wgrad)
# ---------------------------------------------------------------------------

# The tensor-core wgrad tile (csrc/wgrad_tile.cuh): an implicit GEMM in
# 3xTF32 whose rows are the (tap, c) pairs, tap-major, in m-tiles of 64
# (WGRAD_ROWS), whose columns are Cob padded to a compiled wgmma width, and
# whose K runs over output positions, one tile of th x tw positions a stage.
# A CTA of one to three consumer warpgroups (WGRAD_CONSUMERS), each holding
# one or two m-tiles (WGRAD_MPW; two only up to 64 lanes, whose
# accumulators fit a thread's registers), and a producer warpgroup shares
# each staged x window and dz tile among its m-tiles; `groups` CTAs cover
# the m-tiles, and `splits` of each walk contiguous shares of the tiles.

WGRAD_ROWS = 64                 # rows of one wgmma tile (kRows)
WGRAD_CONSUMERS = 3             # the most consumer warpgroups a CTA
WGRAD_THREADS = 128 * (WGRAD_CONSUMERS + 1)   # kMaxThreads
WGRAD_MAX_POSITIONS = 64        # output positions of one stage
WGRAD_MPW = (1, 2)              # m-tiles a consumer warpgroup holds
# the largest split workspace the choosers take, [splits, |dw| + |db|] f32:
# the 36.0 MiB that VGG-16's 512 x 512 layers took before the tensor-core
# tile, four shares of a 3x3 layer's dw and db
WGRAD_WORKSPACE_BYTES = 4 * 4 * (9 * 512 * 512 + 512)
# the cost model of the tile search (``wgrad_candidates``), in cycles of one
# SM: the dense TF32 rate in MACs a cycle (as the dgrad's), the share of it
# one to three consumer warpgroups keep busy, and a stage's producer side: a
# fixed part (a cp.async round trip, the barriers), the staged bytes at an
# SM's share of the L2's rate, and the dz pass per element of a thread.
# Set by hand; ``python -m repro_torch.launch.wgrad_tiles_ab`` times the
# candidates on the card, and tests/test_torch_wgrad_tiles.py pins the
# tiles chosen at VGG-16's layers.
WGRAD_MACS_PER_CYCLE = 1024
WGRAD_WG_EFFICIENCY = {1: 0.5, 2: 0.6, 3: 0.65}
WGRAD_STAGE_CYCLES = 1500
WGRAD_BYTES_PER_CYCLE = 20
WGRAD_TRANSFORM_CYCLES = 12
# the card's memory rate in bytes a cycle of the whole card (3.35e12 /
# 1.83e9), for the workspace rows the shares write and the sums they fold
WGRAD_CARD_BYTES_PER_CYCLE = 1830


def wgrad_lanes(cob: int) -> int:
    """The wgmma width the wgrad kernels take for a ``cob`` pencil."""
    lanes = next((n for n in DGRAD_LANES if cob <= n), None)
    if lanes is None:
        raise SmemMisfitError(f"cob={cob} is wider than the wgrad tile's "
                              f"widest wgmma, {DGRAD_LANES[-1]} lanes")
    return lanes


def wgrad_ldx(cib: int, stride: int) -> int:
    """Floats of one staged x cell (``wgrad_tile::x_ld``): ``cib`` rounded
    up to 4, then up to the first value whose ``stride`` multiple is 8 mod
    16, so that an A load's four positions start on four distinct 8-bank
    groups (``cib`` rounded up to 4 where no such value exists)."""
    base = -(-cib // 4) * 4
    return next((ld for ld in range(base, base + 32, 4)
                 if stride * ld % 16 == 8), base)


def wgrad_mtiles(hf: int, wf: int, cib: int) -> int:
    """64-row m-tiles of the ``hf * wf * cib`` (tap, c) rows."""
    return -(-hf * wf * cib // WGRAD_ROWS)


def wgrad_smem_bytes(th: int, tw: int, hf: int, wf: int, stride: int,
                     cib: int, cob: int, lanes: int, prologue: bool,
                     op_bytes: int = 4, span: int = 1,
                     dilation=(1, 1), narrow: int = 0) -> int:
    """Dynamic shared memory of one wgrad CTA (``wgrad_tile::smem_bytes``):
    128 bytes to align the base; per slot of the two-slot ring the x window
    ``[hwin][rf]`` (a row's ``wwin`` cells of ``ld`` floats, padded to 128
    bytes, where its TMA box lands), the staged ``g`` (and ``z``)
    ``[K][Cob]`` rounded up to 128 bytes, and B's big and small halves
    ``[K/4][lanes][4]`` (K = th * tw rounded up to 8); the position offsets,
    the db partials and two 8-byte mbarriers a slot.

    bf16 (``op_bytes`` 2, ``wgrad_tile::bf16::smem_bytes``): a 1024-byte
    swizzle atom to align the base, ``wgrad_bf16_slots`` slots of
    ``wgrad_bf16_slot_bytes`` (a CTA of ``span`` m-tiles), 256 bytes of
    tables; no g, z or prologue.  ``dilation`` widens the x window to the
    filter's dilated reach.  ``narrow``: the narrow rows' two raw buffers
    after the slots (``wgrad_bf16_raw_bytes``)."""
    if op_bytes == 2:
        slot = wgrad_bf16_slot_bytes(th, tw, hf, wf, stride, cib, lanes, span,
                                     dilation, narrow)
        raw = wgrad_bf16_raw_bytes(th, tw, hf, wf, stride, cib, narrow)
        return (WGRAD_BF16_ATOM + wgrad_bf16_slots(slot, raw) * slot + raw
                + WGRAD_BF16_TABLES)
    rows, bands, cells = wgrad_staged(th, tw, hf, wf, stride, dilation)
    kpos = -(-th * tw // 8) * 8
    x = rows * bands * -(-cells * wgrad_ldx(cib, stride) // 32) * 32
    raw = -(-kpos * cob // 32) * 32
    slot = x + (2 if prologue else 1) * raw + 2 * kpos * lanes
    return 128 + 4 * (2 * slot + WGRAD_MAX_POSITIONS + 128) + 8 * 4


# The bf16 build of the tile (``wgrad_tile::bf16``) is another GEMM on the
# same rows and columns: an m-tile is one tap x 64 channels (a half of the
# Ci block), A the staged x window and B the dz tile, both read from shared
# memory by descriptor in 128-byte swizzled rows (a cell or a position a
# row), K in k16 steps of 8-position groups that are 8 consecutive cells
# (``tw`` a multiple of 8 but at 1x1 stride 1), the window staged in
# ``wgrad_bf16_phases`` column phases (tap (dh, dw) at dilation d reads
# phase (dw d) % s, (dw d) / s cells on), up to WGRAD_BF16_MAX_POSITIONS
# positions a stage in a ring of 2-4 slots.  A CTA's ``span`` = wgs * mpw
# m-tiles are taps of one half, or whole halves where they cover a half's
# taps (``wgrad_bf16_groups``); widths 64 and 128 only.
WGRAD_BF16_ROW = 128                # bytes of a swizzled row (64 bf16)
WGRAD_BF16_ATOM = 1024              # the swizzle's period, 8 rows
WGRAD_BF16_TABLES = 256
WGRAD_BF16_MAX_POSITIONS = 256
WGRAD_BF16_SLOTS = (2, 4)
WGRAD_BF16_LANES = (64, 128)
# the CTA's limit the C++ sizes its ring against (kSmemBlock)
WGRAD_SMEM_BLOCK = 232448


def wgrad_bf16_lanes(cob: int) -> int:
    """The bf16 build's wgmma width for a ``cob`` pencil: 64 or 128."""
    lanes = next((n for n in WGRAD_BF16_LANES if cob <= n), None)
    if lanes is None:
        raise SmemMisfitError(f"cob={cob} is wider than the wgrad tile's "
                              f"widest wgmma, {WGRAD_BF16_LANES[-1]} lanes")
    return lanes


def wgrad_window(th: int, tw: int, hf: int, wf: int, stride: int,
                 dilation=(1, 1)) -> tuple[int, int]:
    """The x window of a ``th x tw`` tile of output positions: ``(th - 1) s
    + (hf - 1) dh + 1`` rows by the same in columns (``wgrad_tile::hwin``,
    ``wwin``)."""
    return ((th - 1) * stride + fwd_reach(hf, dilation[0]),
            (tw - 1) * stride + fwd_reach(wf, dilation[1]))


def wgrad_staged(th: int, tw: int, hf: int, wf: int, stride: int,
                 dilation=(1, 1)) -> tuple[int, int, int]:
    """``(rows, bands a row, cells a band)`` of the f32 wgrad's staged x
    window (``wgrad_tile::x_rows``, ``box_cells``): where a tap's band of
    ``(th - 1) s + 1`` rows is shorter than the dilation, the ``hf`` bands
    alone, else the whole span; columns likewise (never at dilation 1)."""
    hwin, wwin = wgrad_window(th, tw, hf, wf, stride, dilation)
    bh, bw = (th - 1) * stride + 1, (tw - 1) * stride + 1
    rows = hf * bh if hf > 1 and bh < dilation[0] else hwin
    if wf > 1 and bw < dilation[1]:
        return rows, wf, bw
    return rows, 1, wwin


def wgrad_bf16_phases(wf: int, stride: int, dw: int = 1) -> int:
    """Column phases the bf16 build stages (``wgrad_tile::bf16::phases``):
    the stride's, or fewer where the filter's dilated reach is shorter."""
    return min(stride, fwd_reach(wf, dw))


def wgrad_bf16_wph(tw: int, wf: int, stride: int, dw: int = 1) -> int:
    """Cells of a column phase's window row (``wgrad_tile::bf16::wph``):
    ``tw + ((wf - 1) dw) // s``."""
    return tw + (fwd_reach(wf, dw) - 1) // stride


def wgrad_bf16_groups(hf: int, wf: int, cib: int, span: int,
                      narrow: int = 0):
    """``(taps a group, groups a half's taps take, halves a group, groups)``
    of a CTA of ``span`` m-tiles (``wgrad_tile::bf16::tpg``, ``gph``,
    ``hpg``, ``groups``); on the narrow rows a "tap" is a group of filter
    rows (``narrow_groups``)."""
    taps = narrow_groups(hf, wf, cib) if narrow else hf * wf
    halves = -(-cib // 64)
    tpg = min(span, taps)
    gph = -(-taps // tpg)
    hpg = max(1, span // tpg)
    return tpg, gph, hpg, -(-halves // hpg) * gph


def wgrad_bf16_slot_bytes(th: int, tw: int, hf: int, wf: int, stride: int,
                          cib: int, lanes: int, span: int,
                          dilation=(1, 1), narrow: int = 0) -> int:
    """One slot of the bf16 ring: the CTA's staged halves, each in every
    column phase (``wgrad_bf16_phases``), a window of ``hwin`` rows of
    ``wgrad_bf16_wph`` cells (at least the tile's positions rounded to 8)
    of 128 bytes in whole 1024-byte atoms, then B, ``lanes / 64`` blocks of
    K (positions rounded to 16) rows.  On the narrow rows the CTA's groups'
    rows, K of 128 bytes each, in place of the window."""
    kpos = -(-th * tw // 16) * 16
    if narrow:
        tpg, _, _, _ = wgrad_bf16_groups(hf, wf, cib, span, narrow)
        return (tpg + lanes // 64) * kpos * WGRAD_BF16_ROW
    hwin, _ = wgrad_window(th, tw, hf, wf, stride, dilation)
    wph = wgrad_bf16_wph(tw, wf, stride, dilation[1])
    cells = max(hwin * wph, -(-th * tw // 8) * 8)
    region = -(-cells * WGRAD_BF16_ROW // WGRAD_BF16_ATOM) * WGRAD_BF16_ATOM
    _, _, hpg, _ = wgrad_bf16_groups(hf, wf, cib, span)
    staged = min(hpg, -(-cib // 64))
    return (staged * wgrad_bf16_phases(wf, stride, dilation[1]) * region
            + lanes // 64 * kpos * WGRAD_BF16_ROW)


def wgrad_bf16_slots(slot: int, raw: int = 0) -> int:
    """Slots of ``slot`` bytes the ring takes beside ``raw`` bytes of the
    narrow rows' raw buffers: as many as fit, up to 4 (0 or 1: the tile
    does not fit)."""
    fit = (WGRAD_SMEM_BLOCK - WGRAD_BF16_ATOM - WGRAD_BF16_TABLES
           - raw) // slot
    return min(WGRAD_BF16_SLOTS[1], fit)


def wgrad_bf16_raw_bytes(th: int, tw: int, hf: int, wf: int, stride: int,
                         cib: int, narrow: int) -> int:
    """The narrow rows' two raw buffers of the tile's input rows, each
    rounded to 128 bytes (``wgrad_tile::bf16::raw_region``); 0 elsewhere."""
    if not narrow:
        return 0
    hwin, wwin = wgrad_window(th, tw, hf, wf, stride)
    return 2 * (-(-narrow_raw_bytes(hwin, cib, wwin) // 128) * 128)


@dataclasses.dataclass(frozen=True)
class WgradBlocking:
    """Launch parameters of one window wgrad.  A stage is a tile of ``th x
    tw`` output positions of one image (``kpos``, its K, rounded up to 8);
    a CTA of ``wgs`` consumer warpgroups of ``mpw`` m-tiles each (and a
    producer) shares each staged ``hwin x wwin`` x window and dz tile among
    its m-tiles, ``lanes`` wide; ``groups`` CTAs cover the m-tiles, and
    ``splits`` shares of each walk the ``tiles`` tiles, whose partial sums
    fill a ``[splits, |dw| + |db|]`` f32 workspace."""
    th: int
    tw: int
    wgs: int
    mpw: int
    lanes: int
    groups: int
    splits: int
    tiles: int
    hwin: int
    wwin: int
    kstep: int = 8          # K's slice: 8 (3xTF32), 16 (the bf16 build)
    # 1: the bf16 window GEMM on the narrow rows (``narrow_fits``): an
    # m-tile a group of filter rows, a 128-byte row a position of it
    narrow: int = 0

    @property
    def kpos(self) -> int:
        return -(-self.th * self.tw // self.kstep) * self.kstep


@dataclasses.dataclass(frozen=True)
class StreamWgradBlocking(WgradBlocking):
    """Launch parameters of one streamed wgrad: the window wgrad's, its
    stage an item of ``hso x wob`` output positions (a strip of a column),
    walked strip by strip down each column, the halo rows two strips share
    kept in the ring."""

    @property
    def hso(self) -> int:
        return self.th

    @property
    def wob(self) -> int:
        return self.tw

    @property
    def items(self) -> int:
        return self.tiles


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """What one wgrad launch runs (``wgrad_tile::plan`` is its C++ twin):
    ``tiles``, the position tiles (items) of one m-tile group, Ci and Co
    block; ``function_macs``, positions x taps x Ci x Co; ``issued_macs``,
    the tensor-core MACs: every tile's K positions over every m-tile, the
    ``lanes`` width, ``products`` each (three for 3xTF32, one in bf16), in
    every (Ci, Co) block; ``smem``, a CTA's dynamic shared memory."""
    tiles: int
    function_macs: int
    issued_macs: int
    smem: int
    window_slots: int = 2
    weight_slots: int = 2
    products: int = 3

    @property
    def padding_share(self) -> float:
        """The share of the issued MACs that are no product of a function
        MAC: m-tile rows past the (tap, c) rows, K past a tile's positions
        or the map, lanes past Cob."""
        if not self.issued_macs:
            return 0.0
        return 1 - self.products * self.function_macs / self.issued_macs


def wgrad_plan(blk: WgradBlocking, n: int, ho: int, wo: int, hf: int,
               wf: int, stride: int, ciblk: int, cib: int, coblk: int,
               cob: int, prologue: bool, groups: int = 1,
               dilation=(1, 1)) -> WgradPlan:
    """What a launch of the tiles ``blk`` runs over ``n`` images of an
    ``ho x wo`` output (the bf16 build where ``blk.kstep`` is 16); ``ciblk``
    is the map's, of which a grouped conv's Co block contracts its group's
    ``ciblk / groups`` (1 / groups of the dense MACs)."""
    op_bytes = 2 if blk.kstep == 16 else 4
    products = 3 if op_bytes == 4 else 1
    if blk.narrow:
        mtiles = narrow_groups(hf, wf, cib)
    else:
        mtiles = (-(-cib // 64) * hf * wf if op_bytes == 2
                  else wgrad_mtiles(hf, wf, cib))
    cigblk = ciblk // groups
    return WgradPlan(
        tiles=blk.tiles,
        function_macs=n * ho * wo * hf * wf * cib * cigblk * cob * coblk,
        issued_macs=(cigblk * coblk * blk.tiles * blk.kpos * mtiles
                     * WGRAD_ROWS * blk.lanes * products),
        smem=wgrad_smem_bytes(blk.th, blk.tw, hf, wf, stride, cib, cob,
                              blk.lanes, prologue, op_bytes,
                              blk.wgs * blk.mpw, dilation, blk.narrow),
        products=products)


def _wgrad_shapes(ho: int, wo: int, hso: int | None):
    """The stage shapes the search weighs: for each row count (``hso``
    pinned, else 1-8), the widths that fill K = 8, 16, ..., 64 positions."""
    rows = [hso] if hso is not None else range(1, min(ho, 8) + 1)
    out = []
    for th in rows:
        for k in range(8, WGRAD_MAX_POSITIONS + 1, 8):
            tw = min(wo, k // th)
            if tw >= 1 and th * tw <= WGRAD_MAX_POSITIONS:
                out.append((th, tw))
    return list(dict.fromkeys(out))


def wgrad_candidates(n: int, ho: int, wo: int, hf: int, wf: int,
                     stride: int, ciblk: int, cib: int, coblk: int, cob: int,
                     machine: MachineModel, prologue: bool, streamed: bool,
                     hso: int | None = None, op_bytes: int = 4,
                     groups: int = 1, dilation=(1, 1),
                     narrow: bool | None = None):
    """The tiles the search weighs, each as ``(key, blocking)``, the least
    key the choice.  For each stage shape (``_wgrad_shapes``) whose shared
    memory fits ``machine.smem_block``, consumer count and m-tiles a
    warpgroup, and share count (the grid filling one to eight waves of
    ``machine.sms`` or just short of them, and the most shares
    ``WGRAD_WORKSPACE_BYTES`` holds), the key's
    cost estimates the busiest SM's cycles: its CTAs' stages, each the
    longer of the consumers' three-product wgmmas (at
    ``WGRAD_MACS_PER_CYCLE``, the share ``WGRAD_WG_EFFICIENCY`` of it they
    keep busy) and the producer's stage (a fixed part, the bytes of its
    window and dz tile at ``WGRAD_BYTES_PER_CYCLE`` and its dz pass), plus
    a first stage a CTA; the workspace the shares write; and the folded
    sum's tail, one column's rows read by one SM at
    ``SPLIT_SUM_BYTES_PER_CYCLE``.  Ties go to fewer shares, then larger
    stages.  ``op_bytes`` 2 weighs the bf16 build
    (``_wgrad_bf16_candidates``; ``narrow`` as there).  A grouped conv's
    grid walks its ``ciblk / groups`` input blocks a Co block, and its dw
    has that many; ``dilation`` widens the x window to the filter's dilated
    reach."""
    kstep = _fwd_k_step(op_bytes)
    ciblk //= groups
    if kstep == 16:
        return _wgrad_bf16_candidates(n, ho, wo, hf, wf, stride, ciblk, cib,
                                      coblk, cob, machine, streamed, hso,
                                      dilation, narrow)
    lanes = wgrad_lanes(cob)
    mt = wgrad_mtiles(hf, wf, cib)
    cols = coblk * ciblk * hf * wf * cib * cob + coblk * cob
    cls = StreamWgradBlocking if streamed else WgradBlocking
    out = []
    for th, tw in _wgrad_shapes(ho, wo, hso):
        smem = wgrad_smem_bytes(th, tw, hf, wf, stride, cib, cob, lanes,
                                prologue, op_bytes, dilation=dilation)
        if smem > machine.smem_block:
            continue
        kpos = -(-th * tw // kstep) * kstep
        hwin, wwin = wgrad_window(th, tw, hf, wf, stride, dilation)
        tiles = n * -(-ho // th) * -(-wo // tw)
        # the streamed walk's kept halo rows cost its producer a move in
        # shared memory, as much as their TMA copy from L2 costs the window
        # kernel's: both stage the whole window
        rows, bands, cells = wgrad_staged(th, tw, hf, wf, stride, dilation)
        staged = op_bytes * (rows * bands * cells * cib
                             + th * tw * cob * (2 if prologue else 1))
        producer = (WGRAD_STAGE_CYCLES + staged / WGRAD_BYTES_PER_CYCLE
                    + kpos * lanes / 128 * WGRAD_TRANSFORM_CYCLES)
        for wgs in range(1, WGRAD_CONSUMERS + 1):
            for mpw in WGRAD_MPW:
                if (lanes * mpw > 128 or (mpw > 1 and mt == 1)
                        or (wgs - 1) * mpw >= mt):
                    continue
                groups = -(-mt // (wgs * mpw))
                column = min(hf * wf * cib, wgs * mpw * WGRAD_ROWS) * cob
                mma = (mt / groups * kpos / 8 * 3 * WGRAD_ROWS * lanes * 8
                       / WGRAD_MACS_PER_CYCLE / WGRAD_WG_EFFICIENCY[wgs])
                stage = max(mma, producer)
                base = groups * ciblk * coblk
                # shares that fill whole waves or come just short of them,
                # and the most the workspace holds
                most = max(1, min(tiles, WGRAD_WORKSPACE_BYTES // (4 * cols)))
                shares = {most}
                for waves in range(1, 9):
                    shares |= {max(1, waves * machine.sms // base),
                               -(-waves * machine.sms // base)}
                for splits in sorted(k for k in shares if k <= most):
                    ctas = base * splits
                    cost = (-(-ctas // machine.sms)
                            * (-(-tiles // splits) * stage + producer)
                            + (splits + 1) * cols * 4
                            / WGRAD_CARD_BYTES_PER_CYCLE
                            + splits * column * 4
                            / SPLIT_SUM_BYTES_PER_CYCLE)
                    out.append(((cost, splits, -kpos, -wgs * mpw),
                                cls(th=th, tw=tw, wgs=wgs, mpw=mpw,
                                    lanes=lanes, groups=groups,
                                    splits=splits, tiles=tiles, hwin=hwin,
                                    wwin=wwin, kstep=kstep)))
    return out


# The bf16 GEMM's cost model (``_wgrad_bf16_candidates``), in cycles of one
# SM: the dense bf16 rate in MACs a cycle, the share of it one to three
# consumer warpgroups keep busy, and a stage's staged bytes at an SM's share
# of the L2's rate (TMA, no producer pass), a fixed part a stage and a
# CTA's first stage.  Fitted to ``python -m repro_torch.launch.
# wgrad_tiles_ab --dtype bf16`` on an H100.
WGRAD_BF16_MACS_PER_CYCLE = 2048
WGRAD_BF16_WG_EFFICIENCY = {1: 0.55, 2: 0.8, 3: 0.8}
WGRAD_BF16_BYTES_PER_CYCLE = 24
WGRAD_BF16_STAGE_CYCLES = 400
WGRAD_BF16_FIRST_CYCLES = 16000


def _wgrad_bf16_shapes(ho: int, wo: int, hf: int, wf: int, stride: int,
                       hso: int | None):
    """The bf16 stage shapes: tw a multiple of 8 (8 consecutive cells a
    position group) up to the row rounded to 8, or at 1x1 stride 1 whole
    rows (positions run on across the row breaks; multiples of 16 for rows
    longer than a stage); th rows (``hso`` pinned) up to
    WGRAD_BF16_MAX_POSITIONS positions."""
    top = WGRAD_BF16_MAX_POSITIONS
    if hf == wf == stride == 1:
        widths = [wo] if wo <= top else list(range(16, top + 1, 16))
    else:
        widths = list(range(8, min(-(-wo // 8) * 8, top) + 1, 8))
    out = []
    for tw in widths:
        rows = [hso] if hso is not None else range(1, min(ho, 16) + 1)
        for th in rows:
            if th * tw <= top:
                out.append((th, tw))
    return out


def _wgrad_bf16_candidates(n, ho, wo, hf, wf, stride, ciblk, cib, coblk, cob,
                           machine, streamed, hso, dilation=(1, 1),
                           narrow=None):
    """``wgrad_candidates`` for the bf16 GEMM: each stage shape whose ring
    holds two slots, consumer count and m-tiles a warpgroup (two only at 64
    lanes; two consumers at most where a warpgroup's m-tiles take 128
    lanes), and share count; the key's cost the busiest SM's cycles (its
    CTAs' stages, each the longer of the wgmmas and the staged bytes, plus
    a fixed part, and a first stage a CTA; the workspace; the folded sum's
    tail), ties to fewer shares, then larger stages.  Where the narrow rows
    fit the window kernel at Cib 3 (``narrow_chosen``, Cob a multiple of 8
    and at most 64) their tiles alone (``_wgrad_narrow_candidates``; timed
    faster than the per-tap tiles at each of the three nets' first layers,
    PERF.md), else the per-tap tiles; ``narrow`` True or False asks for one
    path's (True: the rows at any width they fit)."""
    fits = (not streamed and narrow_chosen(hf, wf, cib, dilation, narrow,
                                           NARROW_WGRAD_CIBS)
            and cob % 8 == 0 and cob <= 64)
    if narrow is not False:
        found = (_wgrad_narrow_candidates(n, ho, wo, hf, wf, stride, ciblk,
                                          cib, coblk, cob, machine, hso)
                 if fits else [])
        if narrow or found:
            return found
    lanes = wgrad_bf16_lanes(cob)
    taps, halves = hf * wf, -(-cib // 64)
    mt = halves * taps
    cols = coblk * ciblk * taps * cib * cob
    cls = StreamWgradBlocking if streamed else WgradBlocking
    phases = wgrad_bf16_phases(wf, stride, dilation[1])
    out = []
    for th, tw in _wgrad_bf16_shapes(ho, wo, hf, wf, stride, hso):
        kpos = -(-th * tw // 16) * 16
        hwin, wwin = wgrad_window(th, tw, hf, wf, stride, dilation)
        wph = wgrad_bf16_wph(tw, wf, stride, dilation[1])
        tiles = n * -(-ho // th) * -(-wo // tw)
        for wgs in range(1, WGRAD_CONSUMERS + 1):
            for mpw in WGRAD_MPW:
                if (lanes * mpw > 128 or (mpw > 1 and mt == 1)
                        or (wgs - 1) * mpw >= mt
                        or (lanes * mpw == 128
                            and wgs > BF16_WIDE_CONSUMERS)):
                    continue
                span = wgs * mpw
                slot = wgrad_bf16_slot_bytes(th, tw, hf, wf, stride, cib,
                                             lanes, span, dilation)
                if (wgrad_bf16_slots(slot) < WGRAD_BF16_SLOTS[0]
                        or hwin > 256 or wph > 256
                        or wgrad_smem_bytes(th, tw, hf, wf, stride, cib, cob,
                                            lanes, False, 2, span, dilation)
                        > machine.smem_block):
                    continue
                tpg, _, hpg, groups = wgrad_bf16_groups(hf, wf, cib, span)
                held = min(span, hpg * tpg, mt)
                staged = (min(hpg, halves) * phases * hwin * wph
                          + lanes // 64 * th * tw) * WGRAD_BF16_ROW
                mma = (held * kpos * WGRAD_ROWS * lanes
                       / (WGRAD_BF16_MACS_PER_CYCLE
                          * WGRAD_BF16_WG_EFFICIENCY[wgs]))
                stage = (max(mma, staged / WGRAD_BF16_BYTES_PER_CYCLE)
                         + WGRAD_BF16_STAGE_CYCLES)
                base = groups * ciblk * coblk
                column = held * 64 * cob
                most = max(1, min(tiles, WGRAD_WORKSPACE_BYTES // (4 * cols)))
                shares = {most}
                for waves in range(1, 9):
                    shares |= {max(1, waves * machine.sms // base),
                               -(-waves * machine.sms // base)}
                for splits in sorted(k for k in shares if k <= most):
                    ctas = base * splits
                    cost = (-(-ctas // machine.sms)
                            * (-(-tiles // splits) * stage
                               + WGRAD_BF16_FIRST_CYCLES)
                            + (splits + 1) * cols * 4
                            / WGRAD_CARD_BYTES_PER_CYCLE
                            + splits * column * 4
                            / SPLIT_SUM_BYTES_PER_CYCLE)
                    out.append(((cost, splits, -kpos, -span),
                                cls(th=th, tw=tw, wgs=wgs, mpw=mpw,
                                    lanes=lanes, groups=groups,
                                    splits=splits, tiles=tiles, hwin=hwin,
                                    wwin=wwin, kstep=16)))
    return out


# The narrow rows' wgrad (``_wgrad_narrow_candidates``), in cycles of one
# SM: a stage a fixed part, a part a 128 bytes of its staged raw rows and a
# part a 16-byte chunk of the CTA's groups' rows a producer thread builds
# (the producer bounds it, the wgmmas hide under it), a CTA's first stage
# apart, with the workspace and the folded sum's tail as the per-tap
# tiles'.  Fitted (least squares on the card's times) to the narrow tiles
# ``python -m repro_torch.launch.wgrad_tiles_ab --first`` timed at
# AlexNet's conv1, VGG-16's conv1_1 and MobileNet's conv1 on an H100 80GB
# HBM3 at 700 W; timed again after the fit (PERF.md), it picks the fastest
# tile timed at all three and one within 1.012 of it at Cib 3 7x7 stride 2.
WGRAD_NARROW_STAGE_CYCLES = 1900
WGRAD_NARROW_LINE_CYCLES = 13.5
WGRAD_NARROW_CHUNK_CYCLES = 400
WGRAD_NARROW_FIRST_CYCLES = 22500


def _wgrad_narrow_shapes(ho: int, wo: int, hso: int | None):
    """The narrow rows' stage shapes: positions run on across row breaks,
    so any width: the whole row, the row in two to four balanced parts and
    the multiples of 8 below it; th rows (``hso`` pinned) up to
    WGRAD_BF16_MAX_POSITIONS positions."""
    top = WGRAD_BF16_MAX_POSITIONS
    widths = sorted({-(-wo // k) for k in range(1, 5)}
                    | set(range(8, wo + 1, 8)))
    out = []
    for tw in (w for w in widths if w <= top):
        rows = [hso] if hso is not None else range(1, min(ho, 16) + 1)
        out += [(th, tw) for th in rows if th * tw <= top]
    return out


def _wgrad_narrow_candidates(n, ho, wo, hf, wf, stride, ciblk, cib, coblk,
                             cob, machine, hso):
    """``_wgrad_bf16_candidates`` on the narrow rows (the window kernel; the
    rules of ``wgrad_tile::bf16::valid`` on ``narrow``): an m-tile a group
    of filter rows, 64 lanes and an m-tile a warpgroup (the compiled
    instance), the same consumers and shares."""
    lanes = wgrad_bf16_lanes(cob)
    if lanes != 64:
        return []
    mt = narrow_groups(hf, wf, cib)
    nq = narrow_chunks(hf, wf, cib)
    cols = coblk * ciblk * hf * wf * cib * cob
    out = []
    for th, tw in _wgrad_narrow_shapes(ho, wo, hso):
        kpos = -(-th * tw // 16) * 16
        hwin, wwin = wgrad_window(th, tw, hf, wf, stride)
        tiles = n * -(-ho // th) * -(-wo // tw)
        raw = wgrad_bf16_raw_bytes(th, tw, hf, wf, stride, cib, 1)
        for wgs in range(1, min(WGRAD_CONSUMERS, mt) + 1):
            span = wgs           # an m-tile a warpgroup
            slot = wgrad_bf16_slot_bytes(th, tw, hf, wf, stride, cib,
                                         lanes, span, narrow=1)
            if (wgrad_bf16_slots(slot, raw) < WGRAD_BF16_SLOTS[0]
                    or wgrad_smem_bytes(th, tw, hf, wf, stride, cib, cob,
                                        lanes, False, 2, span,
                                        narrow=1) > machine.smem_block):
                continue
            tpg, _, _, groups = wgrad_bf16_groups(hf, wf, cib, span, 1)
            stage = (WGRAD_NARROW_STAGE_CYCLES
                     + WGRAD_NARROW_LINE_CYCLES * hwin * wwin * cib * 2 / 128
                     + WGRAD_NARROW_CHUNK_CYCLES * tpg * kpos * nq / 128)
            base = groups * ciblk * coblk
            column = min(tpg * narrow_values(hf, wf, cib),
                         hf * wf * cib) * cob
            most = max(1, min(tiles, WGRAD_WORKSPACE_BYTES // (4 * cols)))
            shares = {most}
            for waves in range(1, 9):
                shares |= {max(1, waves * machine.sms // base),
                           -(-waves * machine.sms // base)}
            for splits in sorted(k for k in shares if k <= most):
                ctas = base * splits
                cost = (-(-ctas // machine.sms)
                        * (-(-tiles // splits) * stage
                           + WGRAD_NARROW_FIRST_CYCLES)
                        + (splits + 1) * cols * 4
                        / WGRAD_CARD_BYTES_PER_CYCLE
                        + splits * column * 4
                        / SPLIT_SUM_BYTES_PER_CYCLE)
                out.append(((cost, splits, -kpos, -span),
                            WgradBlocking(th=th, tw=tw, wgs=wgs, mpw=1,
                                          lanes=lanes, groups=groups,
                                          splits=splits, tiles=tiles,
                                          hwin=hwin, wwin=wwin, kstep=16,
                                          narrow=1)))
    return out


def _wgrad_blocking(n, ho, wo, hf, wf, stride, ciblk, cib, coblk, cob,
                    machine, prologue, streamed, hso, what, op_bytes=4,
                    groups=1, dilation=(1, 1)):
    """The least-cost tile of ``wgrad_candidates``."""
    found = wgrad_candidates(n, ho, wo, hf, wf, stride, ciblk, cib, coblk,
                             cob, machine, prologue, streamed, hso, op_bytes,
                             groups, dilation)
    if not found:
        raise SmemMisfitError(
            f"no {what} fits: cib={cib}, cob={cob}, filter {hf}x{wf}, "
            f"stride {stride}, dilation {tuple(dilation)} needs more than "
            f"{machine.smem_block} bytes of shared memory even at one "
            "position")
    return min(found, key=lambda kb: kb[0])[1]


@functools.lru_cache(maxsize=4096)
def choose_wgrad_blocking(n: int, ho: int, wo: int, hf: int, wf: int,
                          stride: int, ciblk: int, cib: int, coblk: int,
                          cob: int, machine: MachineModel = H100_SXM,
                          prologue: bool = False,
                          op_bytes: int = 4, groups: int = 1,
                          dilation=(1, 1)) -> WgradBlocking:
    """Tile the window weight gradient of ``n`` images over an ``ho x wo``
    output (``wgrad_candidates``): each stage stages a tile's whole x
    window, with ``z`` beside its ``g`` when ``prologue``; ``op_bytes`` 2
    for the bf16 build; ``ciblk`` is the map's, ``groups`` and ``dilation``
    ``(dh, dw)`` the conv's."""
    return _wgrad_blocking(n, ho, wo, hf, wf, stride, ciblk, cib, coblk, cob,
                           machine, prologue, False, None, "wgrad tile",
                           op_bytes, groups, tuple(dilation))


# The bf16 dz pass (direct_conv2d_bwd.cu ``dz_kernel_bf16``): one CTA a
# (position share, Co block), enough shares for DZ_WAVES waves of CTAs, at
# least DZ_MIN_POSITIONS positions each; bytes-bound, so any share count
# that fills the card will do, and few shares keep its folded db short.
DZ_WAVES = 2
DZ_MIN_POSITIONS = 64


def dz_splits(n: int, coblk: int, hw: int,
              machine: MachineModel = H100_SXM) -> int:
    """Position shares of each Co block the dz pass takes over ``n``
    images of ``hw`` positions."""
    return max(1, min(n * hw // DZ_MIN_POSITIONS,
                      DZ_WAVES * machine.sms // coblk))


# The split sums folded into the kernels that write their rows
# (csrc/split_sum.cuh): the last CTA of a column of shares reads the
# column's rows alone, at one SM's share of the L2's rate,
# SPLIT_SUM_BYTES_PER_CYCLE bytes a cycle (about 150 GB/s: VGG-16's conv1_2
# and conv2_1 wgrads, one summing CTA against many, on an H100).  The
# separable wgrads take as many shares as one wave of CTAs holds, or one
# CTA an SM where that would give a column more than SPLIT_SUM_COLUMN_BYTES
# of rows: of 1.5, 3, 6 and 32 MiB, 3 timed fastest over MobileNet v1's
# pointwise legs at batch 32 (launch/split_sum_ab.py --column-mib).
SPLIT_SUM_BYTES_PER_CYCLE = 80
SPLIT_SUM_COLUMN_BYTES = 3 << 20


def _splits(tiles: int, base: int, row_bytes: int,
            machine: MachineModel) -> int:
    """Position shares of each of ``base`` columns of a folded split
    reduction whose rows are ``row_bytes`` long: as many as one wave of CTAs
    holds, or one CTA an SM where that would give a column more than
    ``SPLIT_SUM_COLUMN_BYTES`` of rows; at least one, never more than
    tiles."""
    shares = machine.wave // base
    if shares * row_bytes > SPLIT_SUM_COLUMN_BYTES:
        shares = machine.sms // base
    return max(1, min(tiles, shares))


# ---------------------------------------------------------------------------
# pointwise (1x1, stride 1): the channel matmul
# ---------------------------------------------------------------------------

# The tensor-core tile of csrc/conv2d_pointwise.cu (the forward): a GEMM
# in 3xTF32 whose rows are the positions of one image, 64 (PW_ROWS) a
# consumer warpgroup, one to three of them (PW_CONSUMERS), whose columns
# are an output block's lanes padded to a compiled wgmma width (or half of
# them, `nsplit` 2), and whose K walks (input block, channel) `chunk`
# channels a stage through a two-slot ring that a producer warpgroup fills
# by cp.async a stage ahead.  The search weighs each consumer count and
# split with the largest chunk (up to PW_MAX_CHUNK) that fits one CTA's
# shared memory: the busiest SM's stages, each the longer of its
# three-product wgmmas (the dgrad tile's rate and shares,
# DGRAD_MACS_PER_CYCLE and DGRAD_WG_EFFICIENCY) and the rest of a stage, a
# fixed part and the producer's copies and weight split a thread.  The cycle counts were fitted to the timings of every candidate
# at MobileNet's forward legs by `python -m
# repro_torch.launch.pointwise_tiles_ab` on an H100 80GB HBM3 at 700 W;
# there the chosen tiles summed 0.4313 ms over the 13 legs against 0.4264
# for the fastest timed at each.  tests/test_torch_pointwise_tiles.py pins
# the tiles at MobileNet's shapes, so a change here that moves one shows.
# (The pointwise dgrad runs the dense dgrad tile at 1x1, which timed
# faster than this tile with the weight read transposed.)
PW_ROWS = 64
PW_CONSUMERS = 3
PW_SLOTS = 2
PW_MAX_CHUNK = 64
PW_STAGE_CYCLES = 2000      # a stage's copy latency past the ring, barriers
PW_COPY_CYCLES = 30         # one 16-byte cp.async of a producer thread
PW_SPLIT_CYCLES = 3         # a weight transposed and split into halves

# The bf16 build (``op_bytes`` 2; csrc/conv2d_pointwise.cu
# ``pointwise_tile_kernel_bf16``, namespace ``pwbf16``) is a design of its
# own, the dense forward's bf16 design at 1x1: its GEMM rows are the
# flattened (image, position) axis, so an item of ``rows`` = 64 x consumers
# rows may span images and only the batch's last m-tile is ragged; A (x's
# rows, ``chunk`` channels: one 128-, 64- or 32-byte swizzled row a
# position, two at 128 channels) and B (the weights, MN-major) land by TMA
# in a ring of 2-4 slots and are read by descriptor; a persistent grid of
# CTAs walks the (row item, output column) items.  x lands in boxes of
# ``brows`` rows of one image (at most PW_BF16_BOX_ROWS), each at its row's
# place in the slot, so a slot holds ``brows`` spare rows on either side of
# the item's.  The search weighs the consumers (1-3), the chunk, the lane
# split and the ring's slots; the cost, per SM in cycles, is the busiest
# SM's items (in rounds of the card's SMs) of ``stages`` stages each, a
# stage the longer of its wgmmas (the item's live m-tiles at
# PW_BF16_MACS_PER_CYCLE, the share PW_BF16_WG_EFFICIENCY of it one to
# three consumers keep busy) and its copies (a fixed latency shared by the
# slots in flight, the bytes landed at PW_BF16_BYTES_PER_CYCLE, a cost a
# TMA box, and where a pencil takes no TMA a cost a producer thread's
# copy), and an item's epilogue; the rounds count two CTAs an SM where a
# one-consumer CTA's shared memory lets two share it (at batch 8's 14x14
# legs a ring of two slots, so held, timed 1.3x faster than three).  The
# copies path is weighed only where no tile takes TMA.  The constants were
# fitted (a random search, the legs' chosen-over-fastest sum the
# objective, the worse batch's first) to the card's times of the
# candidates at MobileNet's forward legs at batch 8 and 32 that ``python
# -m repro_torch.launch.pointwise_tiles_ab --dtype bf16 --kind fwd
# [--batch 32]`` timed on an H100 80GB HBM3 at 700 W (PERF.md); they are
# a fit, not a description of the card.
PW_BF16_CHUNKS = (128, 64, 32, 16)
PW_BF16_HALF = 64           # channels of one 128-byte swizzled row
PW_BF16_MAX_RING = 4
PW_BF16_BAR_BYTES = 8 * 2 * PW_BF16_MAX_RING
PW_BF16_ATOM = 1024
PW_BF16_BOX_ROWS = 32
PW_BF16_MAX_BOX = 256
# consumers at 128 lanes with GAP, at most (the kernel's launch bound:
# its epilogue at three spilled)
PW_BF16_GAP_WIDE_CONSUMERS = 2
PW_BF16_SM_SMEM = 233472          # an SM's shared memory
PW_BF16_CTA_RESERVED = 1024       # the runtime's share of it a CTA
PW_BF16_MACS_PER_CYCLE = 1197
PW_BF16_WG_EFFICIENCY = {1: 0.44, 2: 0.85, 3: 0.86}
PW_BF16_STAGE_CYCLES = 37
PW_BF16_BYTES_PER_CYCLE = 63
PW_BF16_BOX_CYCLES = 4
PW_BF16_COPY_CYCLES = 11
PW_BF16_ITEM_CYCLES = 277


@dataclasses.dataclass(frozen=True)
class PointwiseBlocking:
    """Launch parameters of the pointwise forward's tile.  The f32 tile: a
    CTA of ``wgs`` consumer warpgroups owns ``rows = 64 * wgs`` consecutive
    positions of one image (``tiles`` an image, the last one ragged) by
    ``lanes`` output lanes (the wgmma width; an output block splits into
    ``nsplit`` CTAs), and contracts ``chunk`` channels a stage.  The bf16
    build: an item is ``rows`` consecutive rows of the flattened (image,
    position) axis by ``lanes`` lanes, ``tiles`` the GAP's partial slots an
    image (the most items that touch one image), ``ring`` the ring's slots
    and ``brows`` the rows of a box of x (both 0 for the f32 tile)."""
    rows: int
    wgs: int
    lanes: int
    nsplit: int
    chunk: int
    tiles: int
    ring: int = 0
    brows: int = 0


@dataclasses.dataclass(frozen=True)
class PointwisePlan:
    """What a launch of the bf16 build runs (``pwbf16::plan``): its items,
    the function's MACs, the tensor-core MACs its live m-tiles issue, a
    CTA's shared memory, its ring slots and the GAP slots an image (0
    without GAP)."""
    items: int
    function_macs: int
    issued_macs: int
    smem: int
    ring: int
    slots: int


def _pw_bf16_cell(chunk: int):
    """``(channels, bytes)`` of one swizzled row of a ``chunk`` stage, and
    the rows of one 128-byte line."""
    half = min(chunk, PW_BF16_HALF)
    return half, 2 * half, 128 // (2 * half)


def pointwise_bf16_brows(hw: int, chunk: int) -> int:
    """Rows of a TMA box of x: up to PW_BF16_BOX_ROWS of one image, whole
    128-byte lines of them."""
    line = _pw_bf16_cell(chunk)[2]
    return max(line, min(hw, PW_BF16_BOX_ROWS) // line * line)


def pointwise_bf16_tma(hw: int, kw: int, ow: int, chunk: int, lanes: int,
                       brows: int) -> bool:
    """Whether the bf16 build lands x and the weights by TMA
    (``pwbf16::tma``): 16-byte strides, whole ``min(lanes, 64)``-lane weight
    rows, x's boxes on whole 128-byte lines inside an image; else the
    producer's copies."""
    line = _pw_bf16_cell(chunk)[2]
    return (kw % 8 == 0 and hw % line == 0 and brows % line == 0
            and brows <= hw and ow % 8 == 0 and ow % min(lanes, 64) == 0)


def pointwise_bf16_gap_slots(n: int, hw: int, rows: int) -> int:
    """The most items of ``rows`` flattened rows that touch one of ``n``
    images of ``hw`` positions (``pwbf16::gap_slots``; the count repeats
    every ``rows`` images)."""
    return max((((k + 1) * hw - 1) // rows - k * hw // rows + 1
                for k in range(min(n, rows))), default=0)


def pointwise_smem_bytes(rows: int, chunk: int, lanes: int, wgs: int,
                         gap: bool = False, op_bytes: int = 4, *,
                         ring: int = 2,
                         brows: int = PW_BF16_BOX_ROWS) -> int:
    """Dynamic shared memory of one pointwise tile CTA (the kernel's
    ``smem_bytes``, ``pwbf16::smem_bytes`` for ``op_bytes`` 2).

    f32: 128 bytes to align the base; per slot of its two-slot ring the
    input rows ``[rows][chunk + 4]``, the raw weight chunk ``[chunk][lanes]``
    and its TF32 halves; an int per k8 step; with ``gap`` the consumer
    warps' ``[4 * wgs][lanes]`` sums.

    bf16: a swizzle period (1024 bytes) to align the base; ``ring`` slots,
    each the A halves (``front + rows + brows`` swizzled rows, ``front`` the
    box rows in whole 128-byte lines) and the weights ``[chunk][lanes]``,
    each in whole swizzle periods; the ring's mbarriers; two f32 bias rows
    of ``lanes``; with ``gap`` the consumer warps' f32 sums and a flag."""
    red = 4 * wgs * lanes if gap else 0
    if _fwd_k_step(op_bytes) == 16:
        atom = PW_BF16_ATOM
        half, cb, line = _pw_bf16_cell(chunk)
        front = -(-brows // line) * line
        a = -(-(front + rows + brows) * cb // atom) * atom
        stage = chunk // half * a + -(-2 * chunk * lanes // atom) * atom
        return (atom + ring * stage + PW_BF16_BAR_BYTES + 8 * lanes
                + (4 * red + 16 if gap else 0))
    return 128 + 4 * (PW_SLOTS * (rows * (chunk + 4) + 3 * chunk * lanes)
                      + chunk // 8 + red)


def pointwise_kpad(kw: int, op_bytes: int = 4) -> int:
    """The input pencil ``kw`` rounded up to the tile's k-slices."""
    k = _fwd_k_step(op_bytes)
    return -(-kw // k) * k


def _pointwise_bf16_candidates(n: int, hw: int, kblk: int, kw: int,
                               oblk: int, ow: int, machine: MachineModel,
                               gap: bool):
    """``pointwise_candidates`` of the bf16 build (see the constants
    above); the same rules as ``pwbf16::valid``."""
    kpad = pointwise_kpad(kw, 2)
    total = n * hw
    out = []
    for wgs in range(1, PW_CONSUMERS + 1):
        rows = PW_ROWS * wgs
        ritems = -(-total // rows)
        live = -(-total // PW_ROWS) / ritems      # live m-tiles an item
        slots = pointwise_bf16_gap_slots(n, hw, rows)
        # images an item touches, on average
        images = (rows - 1) / hw + 1
        for chunk in (c for c in PW_BF16_CHUNKS if kpad % c == 0):
            brows = pointwise_bf16_brows(hw, chunk)
            half = _pw_bf16_cell(chunk)[0]
            stages = kblk * kpad // chunk
            for nsplit, lanes in _fwd_splits(ow):
                if gap and lanes == 128 and wgs > PW_BF16_GAP_WIDE_CONSUMERS:
                    continue
                tma = pointwise_bf16_tma(hw, kw, ow, chunk, lanes, brows)
                items = ritems * oblk * nsplit
                mma = (PW_ROWS * live * chunk * lanes
                       / PW_BF16_MACS_PER_CYCLE / PW_BF16_WG_EFFICIENCY[wgs])
                if tma:
                    landed = rows + min(brows, hw) * min(images, 2)
                    boxes = chunk // half * (rows / min(brows, hw) + images)
                    copies = 0
                else:
                    landed, boxes = rows, 0
                    copies = rows * chunk // 8 + 2 * chunk * lanes // 8
                staged = 2 * chunk * (lanes + landed)
                for ring in range(2, PW_BF16_MAX_RING + 1):
                    smem = pointwise_smem_bytes(rows, chunk, lanes, wgs, gap,
                                                2, ring=ring, brows=brows)
                    if smem > machine.smem_block:
                        break
                    # CTAs an SM holds: two of one consumer where their
                    # shared memory fits (the registers do at 128 a thread)
                    per_sm = (2 if wgs == 1 and smem + PW_BF16_CTA_RESERVED
                              <= PW_BF16_SM_SMEM // 2 else 1)
                    copy = (PW_BF16_STAGE_CYCLES / (ring - 1)
                            + staged / PW_BF16_BYTES_PER_CYCLE
                            + PW_BF16_BOX_CYCLES * boxes
                            + PW_BF16_COPY_CYCLES * copies / 128)
                    cost = (-(-items // (machine.sms * per_sm))
                            * (stages * max(mma, copy)
                               + PW_BF16_ITEM_CYCLES))
                    out.append(((cost, -chunk, -ring, -rows, nsplit),
                                PointwiseBlocking(rows=rows, wgs=wgs,
                                                  lanes=lanes,
                                                  nsplit=nsplit, chunk=chunk,
                                                  tiles=slots, ring=ring,
                                                  brows=brows), tma))
    # the copies path only where no tile takes TMA
    tma = any(t for *_, t in out)
    return [(key, blk) for key, blk, t in out if t or not tma]


def pointwise_candidates(n: int, hw: int, kblk: int, kw: int, oblk: int,
                         ow: int, machine: MachineModel = H100_SXM,
                         gap: bool = False, op_bytes: int = 4):
    """The tiles the search weighs, each as ``(key, PointwiseBlocking)``,
    the least key the choice (see the constants above); ties go to a
    larger chunk, more rows, then fewer splits.  ``op_bytes`` 2 weighs the
    bf16 build (``_pointwise_bf16_candidates``)."""
    if _fwd_k_step(op_bytes) == 16:
        return _pointwise_bf16_candidates(n, hw, kblk, kw, oblk, ow, machine,
                                          gap)
    kpad = pointwise_kpad(kw, op_bytes)
    chunks = [c for c in range(min(kpad, PW_MAX_CHUNK), 0, -8)
              if kpad % c == 0]
    out = []
    for wgs in range(1, PW_CONSUMERS + 1):
        rows = PW_ROWS * wgs
        tiles = -(-hw // rows)
        for nsplit in (1, 2):
            if nsplit > 1 and ow <= DGRAD_LANES[0]:
                continue
            lanes = dgrad_lanes(-(-ow // nsplit))
            if (nsplit - 1) * lanes >= ow:
                continue
            chunk = next((c for c in chunks if pointwise_smem_bytes(
                rows, c, lanes, wgs, gap, op_bytes) <= machine.smem_block),
                None)
            if chunk is None:
                continue
            stages = kblk * kpad // chunk
            ctas = n * tiles * oblk * nsplit
            mma = (3 * rows * chunk * lanes / DGRAD_MACS_PER_CYCLE
                   / DGRAD_WG_EFFICIENCY[wgs])
            copies = (rows * chunk + chunk * lanes) / 4
            split = PW_SPLIT_CYCLES * chunk * lanes
            other = PW_STAGE_CYCLES + (PW_COPY_CYCLES * copies + split) / 128
            cost = -(-ctas // machine.sms) * stages * max(mma, other)
            out.append(((cost, -chunk, -rows, nsplit),
                        PointwiseBlocking(rows=rows, wgs=wgs, lanes=lanes,
                                          nsplit=nsplit, chunk=chunk,
                                          tiles=tiles)))
    return out


@functools.lru_cache(maxsize=4096)
def choose_pointwise_blocking(n: int, hw: int, kblk: int, kw: int,
                              oblk: int, ow: int,
                              machine: MachineModel = H100_SXM,
                              gap: bool = False,
                              op_bytes: int = 4) -> PointwiseBlocking:
    """Tile a channel matmul over ``n`` images of ``hw`` positions that
    contracts ``kblk`` input pencils of ``kw`` channels into ``oblk``
    output pencils of ``ow`` lanes: the least-cost tile of
    ``pointwise_candidates`` (``op_bytes`` 4: the f32 tile, 2: its bf16
    build)."""
    if hw <= 0 or n <= 0:
        raise ValueError(f"empty map: n={n}, hw={hw}")
    found = pointwise_candidates(n, hw, kblk, kw, oblk, ow, machine, gap,
                                 op_bytes)
    if not found:
        raise SmemMisfitError(
            f"no pointwise tile fits: kw={kw}, ow={ow} need more than "
            f"{machine.smem_block} bytes of shared memory at 64 rows")
    return min(found, key=lambda kb: kb[0])[1]


def pointwise_issued_macs(blk: PointwiseBlocking, n: int, kblk: int,
                          kw: int, oblk: int, op_bytes: int = 4,
                          hw: int = 0) -> int:
    """The tensor-core MACs a launch of ``blk`` issues.  f32: every CTA's
    whole ``rows x lanes`` tile over K padded to whole chunks in every
    input block, three products each.  bf16 (over ``n`` images of ``hw``
    positions): every m-tile of 64 flattened rows that holds a row, by
    ``lanes`` over Cib padded to k16 slices, one product each."""
    kpad = pointwise_kpad(kw, op_bytes)
    if op_bytes == 2:
        if hw <= 0:
            raise ValueError("the bf16 build's issued MACs need hw")
        return (-(-n * hw // PW_ROWS) * PW_ROWS * oblk * blk.nsplit
                * blk.lanes * kblk * kpad)
    return (3 * n * blk.tiles * oblk * blk.nsplit * blk.rows
            * blk.lanes * kblk * (-(-kpad // blk.chunk) * blk.chunk))


def pointwise_plan_ints(blk: PointwiseBlocking, n: int, hw: int, kblk: int,
                        kw: int, oblk: int, ow: int, act: int,
                        gap: bool) -> tuple:
    """The bf16 build's plan as the C entry reads it: the
    ``pwbf16::Geometry`` fields in order, the wgmma width and the dynamic
    shared memory."""
    return (kblk, kw, oblk, ow, hw, n, blk.rows, blk.nsplit, blk.chunk, act,
            int(gap), blk.ring, blk.brows, blk.tiles, blk.lanes,
            pointwise_smem_bytes(blk.rows, blk.chunk, blk.lanes, blk.wgs,
                                 gap, 2, ring=blk.ring, brows=blk.brows))


def pointwise_plan(blk: PointwiseBlocking, n: int, hw: int, kblk: int,
                   kw: int, oblk: int, ow: int,
                   gap: bool = False) -> PointwisePlan:
    """What a launch of the bf16 build's tiles ``blk`` runs
    (``pwbf16::plan``)."""
    return PointwisePlan(
        items=-(-n * hw // blk.rows) * oblk * blk.nsplit,
        function_macs=n * hw * kblk * kw * oblk * ow,
        issued_macs=pointwise_issued_macs(blk, n, kblk, kw, oblk, 2, hw),
        smem=pointwise_smem_bytes(blk.rows, blk.chunk, blk.lanes, blk.wgs,
                                  gap, 2, ring=blk.ring, brows=blk.brows),
        ring=blk.ring, slots=blk.tiles if gap else 0)


# ---------------------------------------------------------------------------
# depthwise: the per-lane tap loop
# ---------------------------------------------------------------------------

# filter taps one depthwise thread holds in registers (5x5)
DW_MAX_TAPS = 25
# the most positions of a tile that one depthwise thread computes: bounds a
# tile at (threads // lanes) * DW_THREAD_POSITIONS positions
DW_THREAD_POSITIONS = 32
# the depthwise forward's lane splits of a pencil, narrowest last: a warp's
# 32 lanes still read whole 128-byte lines
DW_LANE_SPLITS = (64, 32)
# items a resident CTA of the depthwise forward should walk, at least, so
# that its ring has one window landing while it runs the taps of another
DW_ITEMS_PER_CTA = 1.5


@dataclasses.dataclass(frozen=True)
class DepthwiseBlocking:
    """Launch parameters of the depthwise forward: an item is a ``hob x
    wob`` tile of the output of one image and channel block over ``lanes``
    lanes of the pencil, staged as a ``hwin x wwin`` input window; ``items``
    of them, walked by a persistent grid of ``grid`` CTAs, two windows in
    flight a CTA."""
    hob: int
    wob: int
    hwin: int
    wwin: int
    lanes: int
    items: int
    grid: int


def _ring_cells(n: int, op_bytes: int) -> int:
    """``n`` cells of ``op_bytes`` rounded up to whole 16 bytes."""
    k = 16 // op_bytes
    return -(-n // k) * k


def depthwise_fwd_smem_bytes(hwin: int, wwin: int, lanes: int,
                             machine: MachineModel = H100_SXM,
                             gap: bool = False, op_bytes: int = 4) -> int:
    """The forward's two staged windows of ``op_bytes`` cells (4: f32, 2:
    the bf16 build; each rounded up to 16 bytes) and with ``gap`` the f32
    ``[position groups, lanes]`` sums beside them."""
    stage = op_bytes * 2 * _ring_cells(hwin * wwin * lanes, op_bytes)
    if gap:
        stage += 4 * (machine.threads // lanes) * lanes
    return stage


def _depthwise_groups(cb: int, machine: MachineModel) -> int:
    if cb > machine.threads:
        raise SmemMisfitError(
            f"pencil Cb={cb} wider than a CTA's "
            f"{machine.threads} threads")
    return machine.threads // cb


def _depthwise_fits(n: int, cblk: int, h: int, w: int, cb: int, window,
                    smem, machine: MachineModel) -> list:
    """Every item ``_depthwise_items`` weighs, as ``(hob, wob, (hwin,
    wwin), lanes, items)``."""
    _depthwise_groups(cb, machine)
    splits = [cb] + [s for s in DW_LANE_SPLITS if s < cb and cb % s == 0]
    fits = []
    for lanes in splits:
        cap = machine.threads // lanes * DW_THREAD_POSITIONS
        for hob in divisors(h):
            for wob in divisors(w):
                win = window(hob, wob)
                if hob * wob <= cap and smem(hob, wob, *win, lanes) \
                        <= machine.smem_budget:
                    items = n * cblk * (cb // lanes) * (h // hob) * (w // wob)
                    fits.append((hob, wob, win, lanes, items))
    return fits


def _depthwise_items(n: int, cblk: int, h: int, w: int, cb: int, window,
                     smem, machine: MachineModel, what: str
                     ) -> DepthwiseBlocking:
    """The item walk of the depthwise forward and dgrad over an ``h x w``
    map: tiles dividing it, over the whole pencil or a lane split of it
    (``DW_LANE_SPLITS``); ``window(hob, wob)`` is a tile's staged window and
    ``smem(hob, wob, hwin, wwin, lanes)`` the bytes of its ring, which must
    fit the budget.  A thread holds one lane and up to ``DW_THREAD_POSITIONS``
    positions of it.  Among the items that give every position group a
    position, where some count reaches ``DW_ITEMS_PER_CTA`` per resident
    CTA (``machine.wave``) the largest item (positions x lanes) of those is
    taken, ties to the least staged cells a position, then the wider tile;
    where none does, the most items.  The grid is the card's resident CTAs,
    or the items where they are fewer."""
    fits = _depthwise_fits(n, cblk, h, w, cb, window, smem, machine)
    if not fits:
        raise SmemMisfitError(
            f"no {what} fits: Cb={cb} needs more than {machine.smem_budget} "
            "bytes of shared memory even at 1x1")

    def halo(f) -> float:
        return f[2][0] * f[2][1] / (f[0] * f[1])

    busy = [f for f in fits
            if f[0] * f[1] >= machine.threads // f[3]] or fits
    full = [f for f in busy if f[4] >= DW_ITEMS_PER_CTA * machine.wave]
    if full:
        hob, wob, win, lanes, items = max(
            full, key=lambda f: (f[0] * f[1] * f[3], -halo(f), f[1]))
    else:
        hob, wob, win, lanes, items = max(
            busy, key=lambda f: (f[4], -halo(f), f[1]))
    return DepthwiseBlocking(hob=hob, wob=wob, hwin=win[0], wwin=win[1],
                             lanes=lanes, items=items,
                             grid=min(items, machine.wave))


@functools.lru_cache(maxsize=4096)
def choose_depthwise_blocking(n: int, cblk: int, ho: int, wo: int, cb: int,
                              hf: int, wf: int, stride: int = 1,
                              dilation=(1, 1),
                              machine: MachineModel = H100_SXM,
                              gap: bool = False,
                              op_bytes: int = 4) -> DepthwiseBlocking:
    """Tile the depthwise forward over its ``ho x wo`` output
    (``_depthwise_items``): a tile's window is its halo'd input, two of
    them (and with ``gap`` the position groups' sums) in a CTA's shared
    memory, at ``op_bytes`` a cell (2: the bf16 build)."""
    return _depthwise_items(
        n, cblk, ho, wo, cb,
        lambda hob, wob: halo_dims(hob, wob, hf, wf, stride, dilation),
        lambda hob, wob, hwin, wwin, lanes: depthwise_fwd_smem_bytes(
            hwin, wwin, lanes, machine, gap, op_bytes),
        machine, f"depthwise tile (filter {hf}x{wf}, stride {stride}, "
        f"dilation {dilation})")


def depthwise_dgrad_window(hob: int, wob: int, hi: int, wi: int, hf: int,
                           wf: int, stride: int, dilation, pads
                           ) -> tuple[int, int]:
    """Cotangent rows/cols of the window a ``hob x wob`` tile of dx (tiles
    dividing ``hi x wi``) stages: dx row ``i`` takes cotangent rows ``(i +
    pt - dh * dil) / stride`` where the division is exact, so a tile from
    row ``i0`` reads rows ``floor((i0 + pt - (hf - 1) * dil) / stride)``
    to ``floor((i0 + hob - 1 + pt) / stride)``; the window is the widest
    such span over the tiles (their origins' phases against the
    stride)."""
    def span(tile: int, full: int, f: int, d: int, pad: int) -> int:
        return max((i0 + tile - 1 + pad) // stride
                   - (i0 + pad - (f - 1) * d) // stride + 1
                   for i0 in range(0, min(full, tile * stride), tile))
    return (span(hob, hi, hf, dilation[0], pads[0][0]),
            span(wob, wi, wf, dilation[1], pads[1][0]))


def depthwise_dgrad_smem_bytes(hwin: int, wwin: int, lanes: int,
                               prologue: bool, op_bytes: int = 4) -> int:
    """The dgrad's ring: two slots, each the cotangent window ``[hwin, wwin,
    lanes]`` of ``op_bytes`` cells (rounded up to 16 bytes), and with the
    prologue the window of ``z`` beside it."""
    return op_bytes * 2 * (2 if prologue else 1) * _ring_cells(
        hwin * wwin * lanes, op_bytes)


def depthwise_dgrad_variant(hf: int, wf: int, stride: int,
                            dilation) -> int:
    """The dgrad's and the wgrad's kernel variant: 1 or 2 for a 3x3 filter
    at dilation 1 and that stride (the register path; the dgrad's phase
    split, the wgrad's runs of a row), 0 for any other filter, stride and
    dilation (the tap loop)."""
    fast = (hf, wf, tuple(dilation)) == (3, 3, (1, 1))
    return stride if fast and stride in (1, 2) else 0


@functools.lru_cache(maxsize=4096)
def choose_depthwise_dgrad_blocking(n: int, cblk: int, hi: int, wi: int,
                                    cb: int, hf: int, wf: int,
                                    stride: int = 1, dilation=(1, 1),
                                    pads=((1, 1), (1, 1)),
                                    prologue: bool = True,
                                    machine: MachineModel = H100_SXM,
                                    op_bytes: int = 4
                                    ) -> DepthwiseBlocking:
    """Tile the depthwise dgrad over the unpadded ``hi x wi`` input
    (``_depthwise_items``): an item is a tile of dx, its window the
    cotangent cells that feed it (``depthwise_dgrad_window``, under the
    forward's ``pads``, SAME's at a 3x3 filter by default), two of them
    (with the ``prologue``, with ``z`` beside each) in a CTA's shared
    memory, at ``op_bytes`` a cell (2: the bf16 build)."""
    return _depthwise_items(
        n, cblk, hi, wi, cb,
        lambda hob, wob: depthwise_dgrad_window(hob, wob, hi, wi, hf, wf,
                                                stride, dilation, pads),
        lambda hob, wob, hwin, wwin, lanes: depthwise_dgrad_smem_bytes(
            hwin, wwin, lanes, prologue, op_bytes),
        machine, f"depthwise dgrad tile (filter {hf}x{wf}, stride {stride}, "
        f"dilation {dilation})")


def depthwise_dgrad_taps(hi: int, wi: int, hf: int, wf: int, stride: int,
                         dilation, pads) -> tuple[int, int]:
    """What the dgrad kernel's variant runs over one ``hi x wi`` map of one
    lane: ``(phases, taps)``.  The phase split (variant 2) runs at each dx
    position only its phase's taps, ``ceil((f - ph) / 2)`` a row and a
    column phase ``ph`` of ``(i + pt) % 2``; the register path and the tap
    loop run every tap at every position (the loop skips the products of
    those whose divisions are not exact)."""
    if depthwise_dgrad_variant(hf, wf, stride, dilation) != 2:
        return 1, hi * wi * hf * wf

    def axis(extent: int, pad: int):
        return [sum(1 for i in range(extent) if (i + pad) % 2 == ph)
                * -(-(3 - ph) // 2) for ph in (0, 1)]
    rows, cols = axis(hi, pads[0][0]), axis(wi, pads[1][0])
    return 4, sum(rows) * sum(cols)


@dataclasses.dataclass(frozen=True)
class DepthwiseWgradBlocking:
    """Launch parameters of the depthwise wgrad: an item is a ``hob x wob``
    tile of the output positions of one image over ``lanes`` lanes of one
    channel block's pencil, staged as its ``hwin x wwin`` x window beside
    its g (and z) tile.  A column is a (channel block, lane group): its
    ``per_column`` items (images x tiles) are walked in ``splits``
    contiguous shares, one CTA each, two items in flight a CTA; a share's
    sums go to one row of the ``[splits, |dw| + |db|]`` workspace, which the
    column's last CTA adds in split order."""
    hob: int
    wob: int
    hwin: int
    wwin: int
    lanes: int
    per_column: int
    splits: int

    def columns(self, cblk: int, cb: int) -> int:
        """(channel block, lane group) columns of a ``cblk x cb`` map."""
        return cblk * (cb // self.lanes)


def depthwise_wgrad_smem_bytes(hwin: int, wwin: int, hob: int, wob: int,
                               lanes: int, taps: int, prologue: bool,
                               machine: MachineModel = H100_SXM,
                               op_bytes: int = 4) -> int:
    """The wgrad's ring: two slots, each an item's x window ``[hwin, wwin,
    lanes]`` and its g tile ``[hob, wob, lanes]`` (with the prologue z's
    beside it) of ``op_bytes`` cells, each rounded up to 16 bytes; or the
    f32 position groups' ``[threads / lanes, taps + 1, lanes]`` sums where
    those are larger (they reuse the ring once the walk is done)."""
    slot = _ring_cells(hwin * wwin * lanes, op_bytes) \
        + (2 if prologue else 1) * _ring_cells(hob * wob * lanes, op_bytes)
    red = (machine.threads // lanes) * (taps + 1) * lanes
    return max(op_bytes * 2 * slot, 4 * red)


@functools.lru_cache(maxsize=4096)
def choose_depthwise_wgrad_blocking(n: int, cblk: int, ho: int, wo: int,
                                    cb: int, hf: int, wf: int,
                                    stride: int = 1, dilation=(1, 1),
                                    prologue: bool = True,
                                    machine: MachineModel = H100_SXM,
                                    op_bytes: int = 4
                                    ) -> DepthwiseWgradBlocking:
    """Tile the depthwise weight gradient as the forward's items
    (``_depthwise_items``) over its ``ho x wo`` output: a tile's window is
    its halo'd input, staged with its g (and with the ``prologue`` z) tile,
    two items' worth (or the position groups' sums) in a CTA's shared
    memory, at ``op_bytes`` a cell (2: the bf16 build).  Each column's
    items go to as many contiguous shares as one wave of CTAs holds, or one
    CTA an SM where that would give a column's summing CTA too many rows
    (``_splits``)."""
    window, smem = _depthwise_wgrad_rules(hf, wf, stride, dilation,
                                          prologue, machine, op_bytes)
    items = _depthwise_items(
        n, cblk, ho, wo, cb, window, smem, machine,
        f"depthwise wgrad tile (filter {hf}x{wf}, stride {stride}, "
        f"dilation {tuple(dilation)})")
    return _depthwise_wgrad_shares(n, cblk, ho, wo, cb, items.hob,
                                   items.wob, items.hwin, items.wwin,
                                   items.lanes, hf * wf, machine)


def _depthwise_wgrad_rules(hf: int, wf: int, stride: int, dilation,
                           prologue: bool, machine: MachineModel,
                           op_bytes: int = 4):
    """The wgrad's ``window`` and ``smem`` rules for ``_depthwise_fits``."""
    taps = hf * wf
    if taps > DW_MAX_TAPS:
        raise ValueError(f"filter {hf}x{wf} has more than {DW_MAX_TAPS} taps")
    dilation = tuple(dilation)
    return (lambda hob, wob: halo_dims(hob, wob, hf, wf, stride, dilation),
            lambda hob, wob, hwin, wwin, lanes: depthwise_wgrad_smem_bytes(
                hwin, wwin, hob, wob, lanes, taps, prologue, machine,
                op_bytes))


def _depthwise_wgrad_shares(n, cblk, ho, wo, cb, hob, wob, hwin, wwin,
                            lanes, taps, machine) -> DepthwiseWgradBlocking:
    per_column = n * (ho // hob) * (wo // wob)
    columns = cblk * (cb // lanes)
    return DepthwiseWgradBlocking(
        hob=hob, wob=wob, hwin=hwin, wwin=wwin, lanes=lanes,
        per_column=per_column,
        splits=_splits(per_column, columns, 4 * (taps + 1) * lanes, machine))


def depthwise_wgrad_candidates(n: int, cblk: int, ho: int, wo: int, cb: int,
                               hf: int, wf: int, stride: int = 1,
                               dilation=(1, 1), prologue: bool = True,
                               machine: MachineModel = H100_SXM,
                               op_bytes: int = 4
                               ) -> list[DepthwiseWgradBlocking]:
    """Every item the wgrad's chooser weighs, with its shares
    (``launch/separable_bwd_ab.py`` times them)."""
    window, smem = _depthwise_wgrad_rules(hf, wf, stride, dilation,
                                          prologue, machine, op_bytes)
    return [_depthwise_wgrad_shares(n, cblk, ho, wo, cb, hob, wob, *win,
                                    lanes, hf * wf, machine)
            for hob, wob, win, lanes, _ in _depthwise_fits(
                n, cblk, ho, wo, cb, window, smem, machine)]


# ---------------------------------------------------------------------------
# streamed (halo-ring) kernels: csrc/conv2d_stream.cu
# ---------------------------------------------------------------------------
#
# The streamed forward is the dense forward tile (above), streamed: its band
# is two or three strips of ``hso`` output rows, each strip one warpgroup's
# m-tile, and a stage's input rows arrive strip by strip, each halo row
# once (``choose_stream_fwd_blocking``).
#
# The streamed dgrad is the phase-split tensor-core tile of the window
# dgrad (above), streamed: its band is two or three strips of ``hso`` phase
# rows, each strip one m-tile, and a stage's cotangent rows arrive strip by
# strip (``choose_stream_dgrad_blocking``).
#
# The streamed wgrad is the tensor-core wgrad tile (above), streamed: a
# stage is an item of ``hso`` output rows by ``wob`` columns, walked strip
# by strip down each column, and the halo rows two strips share stay in the
# ring (``choose_stream_wgrad_blocking``).


@functools.lru_cache(maxsize=4096)
def choose_stream_fwd_blocking(n: int, ho: int, wo: int, hf: int, wf: int,
                               stride: int, ciblk: int, cib: int, coblk: int,
                               cob: int, machine: MachineModel = H100_SXM,
                               gap: bool = False, hso: int | None = None,
                               op_bytes: int = 4) -> FwdBlocking:
    """Tile the streamed forward (``fwd_candidates``): a band of two or
    three strips of ``hso`` output rows (``hso`` pins it, and must divide
    ``ho``), each one consumer warpgroup's m-tile, whose input rows arrive
    strip by strip; ``op_bytes`` as the window chooser's."""
    if hso is not None and (hso < 1 or ho % hso):
        raise ValueError(f"hso={hso} must divide the rows {ho}")
    if hso is not None and hso > FWD_ROWS:
        raise ValueError(f"hso={hso} rows exceed a strip's {FWD_ROWS} "
                         "positions")
    return _fwd_blocking(n, ho, wo, hf, wf, stride, ciblk, cib, coblk, cob,
                         machine, gap, True, hso, "streamed band", op_bytes)


@functools.lru_cache(maxsize=4096)
def choose_stream_dgrad_blocking(n: int, hi: int, wi: int, hf: int, wf: int,
                                 stride: int, ciblk: int, cib: int, cob: int,
                                 machine: MachineModel = H100_SXM,
                                 prologue: bool = False,
                                 hso: int | None = None,
                                 op_bytes: int = 4) -> DgradBlocking:
    """Tile the streamed dgrad over the unpadded ``hi x wi`` input
    (``_dgrad_blocking``): a band of two or three strips of ``hso`` phase
    rows (``hso`` pins it), each one consumer warpgroup's m-tile, whose
    cotangent rows arrive strip by strip, with ``z`` beside them when
    ``prologue``; ``op_bytes`` 2 for the bf16 build."""
    if hso is not None and hso < 1:
        raise ValueError(f"hso={hso} must be >= 1")
    return _dgrad_blocking(n, hi, wi, hf, wf, stride, ciblk, cib, cob,
                           machine, prologue, True, hso, "streamed dgrad",
                           op_bytes)


@functools.lru_cache(maxsize=4096)
def choose_stream_wgrad_blocking(n: int, ho: int, wo: int, hf: int, wf: int,
                                 stride: int, ciblk: int, cib: int,
                                 coblk: int, cob: int,
                                 machine: MachineModel = H100_SXM,
                                 prologue: bool = False,
                                 hso: int | None = None,
                                 op_bytes: int = 4
                                 ) -> StreamWgradBlocking:
    """Tile the streamed weight gradient (``wgrad_candidates``): items of
    ``hso x wob`` output positions walked strip by strip down each column,
    the shared halo rows kept, only fresh rows staged; ``hso`` pins the
    strip height, which must divide ``ho``; ``op_bytes`` 2 for the bf16
    build."""
    if hso is not None and (hso < 1 or ho % hso):
        raise ValueError(f"hso={hso} must divide Ho={ho}")
    if hso is not None and hso > WGRAD_MAX_POSITIONS:
        raise ValueError(f"hso={hso} rows exceed a stage's "
                         f"{WGRAD_MAX_POSITIONS} positions")
    return _wgrad_blocking(n, ho, wo, hf, wf, stride, ciblk, cib, coblk, cob,
                           machine, prologue, True, hso,
                           "streamed wgrad strip", op_bytes)
