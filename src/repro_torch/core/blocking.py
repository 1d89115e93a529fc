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

from repro_torch.core.conv2d_common import halo_dims
from repro_torch.core.errors import TransientError
from repro_torch.core.layout import divisors

__all__ = ["SmemMisfitError", "MachineModel", "H100_SXM",
           "FWD_ROWS", "FWD_CONSUMERS", "FWD_THREADS", "FWD_WIDE_CONSUMERS",
           "FWD_K_STEP", "fwd_kpad", "FwdBlocking",
           "fwd_smem_bytes", "FwdPlan", "fwd_plan", "fwd_candidates",
           "choose_fwd_blocking", "dgrad_extents", "dgrad_window",
           "DGRAD_ROWS", "DGRAD_LANES", "DGRAD_CONSUMERS", "PhaseAxis",
           "dgrad_phase_axes", "dgrad_lanes", "DgradBlocking",
           "dgrad_smem_bytes", "dgrad_tiles", "DgradPlan", "dgrad_plan",
           "dgrad_candidates", "choose_dgrad_blocking",
           "WGRAD_ROWS", "WGRAD_CONSUMERS", "WGRAD_THREADS",
           "WGRAD_MAX_POSITIONS", "WGRAD_MPW", "WGRAD_WORKSPACE_BYTES",
           "SPLIT_SUM_BYTES_PER_CYCLE", "SPLIT_SUM_COLUMN_BYTES",
           "wgrad_lanes", "wgrad_ldx", "wgrad_mtiles", "WgradBlocking",
           "StreamWgradBlocking", "wgrad_smem_bytes", "WgradPlan",
           "wgrad_plan", "wgrad_candidates", "choose_wgrad_blocking",
           "PW_ROWS", "PW_CONSUMERS", "PW_MAX_CHUNK", "PointwiseBlocking",
           "pointwise_smem_bytes", "pointwise_candidates",
           "choose_pointwise_blocking", "pointwise_issued_macs",
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
# The bf16 build of the tile (``op_bytes`` 2) contracts bf16 operands on
# bf16 wgmma, k16 steps, one product a MAC: its chunk is a multiple of 16,
# Cib pads to k16 slices, its window and weights take 2 bytes an element,
# and the weights land by TMA straight into the slot the wgmma reads (no
# raw buffer, no split), so a CTA stages chunks four to five times the f32
# tile's.  Its cost is the same model at the bf16 rate (twice the TF32
# MACs a cycle, once a MAC) with no weight split; its constants are the f32
# fit's, not timed for bf16.
FWD_ROWS = 64
FWD_CONSUMERS = 3
FWD_THREADS = 128 * (FWD_CONSUMERS + 1)     # the largest CTA (kMaxThreads)
# at 128 lanes a consumer's running sum and stage accumulator take 96
# registers: two consumers at most (kWideConsumers)
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

    @property
    def hso(self) -> int:
        return self.th // self.strips

    @property
    def mstride(self) -> int:
        return FWD_ROWS * self.wgs if self.strips == 1 else self.hso * self.tw


def fwd_smem_bytes(th: int, tw: int, hf: int, wf: int, stride: int,
                   chunk: int, lanes: int, wgs: int,
                   gap: bool = False, op_bytes: int = 4) -> int:
    """Dynamic shared memory of one forward CTA (``fwd_tile::smem_bytes``,
    ``fwd_tile::bf16::smem_bytes`` for ``op_bytes`` 2).

    f32: 128 bytes to align the base; per slot of the two-slot ring the
    input window (``hwin`` rows of ``wwin`` cells of ``chunk + 4`` floats,
    the columns of each stride phase together, rounded up to 128 bytes)
    and the weight chunk's big and small halves ``[taps * chunk /
    4][lanes][4]``; the raw weight chunk; an int a k8 step (an even count);
    the weights' 8-byte mbarrier; with ``gap`` the consumer warps' ``[4 *
    wgs][lanes]`` f32 sums.

    bf16: 128 bytes to align the base; per slot the window (cells of
    ``chunk + 8`` bf16, rounded up to 128 bytes) and the bf16 weight chunk
    ``[taps][lanes / 8][chunk][8]`` as the TMA copy lands it; two ints a
    k16 step (its A and B offsets); an 8-byte mbarrier a slot; the GAP sums
    as f32's."""
    hwin, wwin = (th - 1) * stride + hf, (tw - 1) * stride + wf
    weights = hf * wf * chunk * lanes
    red = 4 * wgs * lanes if gap else 0
    if _fwd_k_step(op_bytes) == 16:
        row = stride * -(-wwin // stride) * (chunk + 8)
        window = -(-hwin * row // 64) * 64
        steps = hf * wf * chunk // 16
        return 128 + 2 * 2 * (window + weights) + 8 * steps + 8 * 2 + 4 * red
    row = stride * -(-wwin // stride) * (chunk + 4)
    window = -(-hwin * row // 32) * 32
    steps = hf * wf * chunk // 8
    return 128 + 8 + 4 * (2 * (window + 2 * weights) + weights
                          + -(-steps // 2) * 2 + red)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """What one forward launch runs (``fwd_tile::plan`` is its C++ twin):
    ``tiles``, an image's tiles; ``function_macs``, positions x taps x Ci
    x Co; ``issued_macs``, the tensor-core MACs: every CTA's ``64 * wgs``
    rows by ``lanes`` over every tap and Cib padded to the k-slices,
    ``products`` each (three for 3xTF32, one for bf16); ``smem``, a CTA's
    dynamic shared memory."""
    tiles: int
    function_macs: int
    issued_macs: int
    smem: int
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
             gap: bool = False, op_bytes: int = 4) -> FwdPlan:
    """What a launch of the tiles ``blk`` runs over ``n`` images of an ``ho
    x wo`` output, with ``op_bytes`` operands."""
    products = 3 if op_bytes == 4 else 1
    return FwdPlan(
        tiles=blk.tiles,
        function_macs=n * ho * wo * hf * wf * ciblk * cib * coblk * cob,
        issued_macs=(products * n * blk.tiles * coblk * blk.nsplit * FWD_ROWS
                     * blk.wgs * blk.lanes * hf * wf * ciblk
                     * fwd_kpad(cib, op_bytes)),
        smem=fwd_smem_bytes(blk.th, blk.tw, hf, wf, stride, blk.chunk,
                            blk.lanes, blk.wgs, gap, op_bytes),
        products=products)


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
                   hso: int | None = None, op_bytes: int = 4):
    """The tiles the search weighs, each as ``(key, FwdBlocking)``, the
    least key the choice (see the constants above); ties go to more rows a
    CTA, a larger chunk, fewer splits, fewer tiles, then a smaller
    window.  ``op_bytes`` 2 weighs the bf16 build."""
    step = _fwd_k_step(op_bytes)
    bf16 = step == 16
    kpad = fwd_kpad(cib, op_bytes)
    # powers of two: a staged cell's copies then divide the producer's 128
    # threads
    chunks = [c for c in (128, 64, 32, 16, 8) if kpad % c == 0 and c >= step]
    taps = hf * wf
    out = []
    for wgs in range(2 if streamed else 1, FWD_CONSUMERS + 1):
        rows = FWD_ROWS * wgs
        for th, tw in _fwd_shapes(ho, wo, wgs, streamed, hso):
            if not streamed and th * tw <= FWD_ROWS * (wgs - 1):
                continue                  # a consumer with no row of its own
            hwin, wwin = (th - 1) * stride + hf, (tw - 1) * stride + wf
            tiles = -(-ho // th) * -(-wo // tw)
            for nsplit in (1, 2):
                if nsplit > 1 and cob <= DGRAD_LANES[0]:
                    continue
                lanes = next((n_ for n_ in DGRAD_LANES
                              if -(-cob // nsplit) <= n_), None)
                if lanes is None or (nsplit - 1) * lanes >= cob or (
                        lanes == DGRAD_LANES[-1]
                        and wgs > FWD_WIDE_CONSUMERS):
                    continue
                fits = [(c, fwd_smem_bytes(th, tw, hf, wf, stride, c, lanes,
                                           wgs, gap, op_bytes))
                        for c in chunks]
                chunk, smem = next(((c, b) for c, b in fits
                                    if b <= machine.smem_block),
                                   (None, None))
                if chunk is None:
                    continue
                res = 2 if wgs == 1 and 2 * smem <= FWD_SM_SMEM else 1
                ctas = n * tiles * coblk * nsplit
                stages = ciblk * kpad // chunk
                # the tensor cores' MACs a cycle: TF32's, twice that in bf16
                # at one product a MAC
                mma = ((1 if bf16 else 3) * res * rows * taps * chunk * lanes
                       / (DGRAD_MACS_PER_CYCLE * (2 if bf16 else 1))
                       / FWD_WG_EFFICIENCY[min(FWD_CONSUMERS, wgs * res)]
                       + FWD_STEP_CYCLES * taps * chunk // step)
                if bf16:     # 16-, 4- or 2-byte window copies; TMA weights
                    copies = (hwin * wwin * chunk
                              / (8 if cib % 8 == 0 else 2 if cib % 2 == 0
                                 else 1)
                              + (0 if cob % 8 == 0 else taps * chunk * lanes))
                    split = 0
                else:
                    copies = (hwin * wwin * chunk / (4 if cib % 4 == 0 else 1)
                              + taps * chunk * lanes / (4 if cob % 4 == 0
                                                        else 1))
                    split = FWD_SPLIT_CYCLES * taps * chunk * lanes
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
                                        wwin=wwin)))
    return out


def _fwd_blocking(n: int, ho: int, wo: int, hf: int, wf: int, stride: int,
                  ciblk: int, cib: int, coblk: int, cob: int,
                  machine: MachineModel, gap: bool, streamed: bool,
                  hso: int | None, what: str,
                  op_bytes: int = 4) -> FwdBlocking:
    """The least-cost tile of ``fwd_candidates``."""
    if ho <= 0 or wo <= 0 or n <= 0:
        raise ValueError(f"empty forward: n={n}, output {ho}x{wo}")
    found = fwd_candidates(n, ho, wo, hf, wf, stride, ciblk, cib, coblk,
                           cob, machine, gap, streamed, hso, op_bytes)
    if not found:
        raise SmemMisfitError(
            f"no {what} fits the forward (filter {hf}x{wf}, stride {stride},"
            f" cib={cib}, cob={cob}): needs more than {machine.smem_block} "
            "bytes of shared memory even at one position")
    return min(found, key=lambda kb: kb[0])[1]


@functools.lru_cache(maxsize=4096)
def choose_fwd_blocking(n: int, ho: int, wo: int, hf: int, wf: int,
                        stride: int, ciblk: int, cib: int, coblk: int,
                        cob: int, machine: MachineModel = H100_SXM,
                        gap: bool = False, op_bytes: int = 4) -> FwdBlocking:
    """Tile the window forward of ``n`` images into an ``ho x wo`` output
    (``fwd_candidates``): a CTA stages the whole input window of its tile a
    stage; ``cib``/``cob`` are the operands' channel pencils, ``op_bytes``
    their element size (4: the f32 tile, 2: its bf16 build)."""
    return _fwd_blocking(n, ho, wo, hf, wf, stride, ciblk, cib, coblk, cob,
                         machine, gap, False, None, "tile", op_bytes)


# ---------------------------------------------------------------------------
# input gradient (dgrad)
# ---------------------------------------------------------------------------

def dgrad_extents(ho: int, wo: int, hf: int, wf: int,
                  stride: int = 1) -> tuple[int, int]:
    """Rows/cols of the *padded* input that a VALID forward ever read,
    ``E = (out - 1) * stride + filter``; rows beyond ``E`` have zero
    gradient.  The kernel writes dx at the unpadded shape and gets those
    zeros from its masks; the plain version sizes its buffer with this."""
    return (ho - 1) * stride + hf, (wo - 1) * stride + wf


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
# correlation over the taps it reaches.  A CTA owns th x tw positions of
# one phase: one to three consumer warpgroups (DGRAD_CONSUMERS), each one
# 64-row wgmma tile (DGRAD_ROWS) of positions by the Cib lanes (padded up
# to a compiled width), and a producer warpgroup that stages through TMA;
# per stage they contract `chunk` Cob channels of one Co block over the
# phase's taps, from a window of the cotangent and the weights split in
# TF32 halves.

DGRAD_ROWS = 64                       # rows of one wgmma tile
DGRAD_LANES = (8, 16, 32, 64, 128)    # compiled wgmma widths
DGRAD_CONSUMERS = 3                   # the most consumer warpgroups a CTA
# the bf16 builds of the dgrad and wgrad tiles at 128 lanes (of m-tiles,
# lanes x mpw, in the wgrad): a consumer's running sum and its stage's
# accumulator take 128 registers a thread, two consumers at most
# (dgrad_tile::bf16::max_threads, wgrad_tile::bf16::max_threads)
BF16_WIDE_CONSUMERS = 2
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
    extent``) take taps ``phase + s*t`` (``t < taps``) from cotangent rows
    ``q0 + a - t``."""
    phase: int
    first: int
    extent: int
    q0: int
    taps: int


def dgrad_phase_axes(extent: int, f: int, stride: int,
                     pad: int) -> tuple[PhaseAxis, ...]:
    """The ``stride`` phases of one axis of an unpadded input of ``extent``
    rows, filter ``f``, leading pad ``pad`` (the kernels' ``phase_axis``)."""
    out = []
    for ph in range(stride):
        first = (ph - pad) % stride
        out.append(PhaseAxis(
            phase=ph, first=first,
            extent=-(-(extent - first) // stride) if first < extent else 0,
            q0=(first + pad - ph) // stride,
            taps=(f - 1 - ph) // stride + 1 if ph < f else 0))
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
                     streamed: bool = False, op_bytes: int = 4) -> int:
    """Dynamic shared memory of one dgrad CTA (``dgrad_tile::smem_bytes``):
    128 bytes to align the base; per slot of the two-slot ring the weights
    of the most taps a phase reaches, ``chunk x lanes``, and their small
    halves, and a ``hwin``-row cotangent window of ``wwin`` cells of
    ``chunk + 4`` floats a row (the streamed kernel's rows padded to 128
    bytes, which boxes of several rows need them to be already; the window
    kernel's whole window one box, padded to 128 bytes), with ``z`` beside
    it with the prologue; one
    int per k8 step of a stage (rounded up to an even count); an 8-byte
    mbarrier per slot and copy group.

    bf16 (``op_bytes`` 2, ``dgrad_tile::bf16::smem_bytes``): per slot the
    bf16 weights alone (no small halves) and windows of ``chunk + 8`` bf16
    cells (rows padded to 128 bytes as f32's); an int per k16 step."""
    taps = -(-hf // stride) * -(-wf // stride)
    if _fwd_k_step(op_bytes) == 16:
        row = wwin * (chunk + 8)
        window = (hwin * -(-row // 64) * 64 if streamed
                  else -(-hwin * row // 64) * 64)
        return (128 + 2 * 2 * (taps * chunk * lanes
                               + (2 if prologue else 1) * window)
                + 4 * -(-taps * chunk // 32) * 2 + 8 * 2 * DGRAD_CONSUMERS)
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
    Cob channels over a ``hwin x wwin`` cotangent window."""
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
                stride: int, pads) -> list[tuple[PhaseAxis, PhaseAxis, int,
                                                 int]]:
    """The CTAs of one image and Ci block, in grid order (``tile_of``):
    ``(row axis, column axis, a0, b0)``, phase by phase, row-major."""
    (pt, _), (pl, _) = pads
    rows = dgrad_phase_axes(hi, hf, stride, pt)
    cols = dgrad_phase_axes(wi, wf, stride, pl)
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
    to k16 slices)."""
    tiles: int
    function_macs: int
    issued_macs: int
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
               cob: int, op_bytes: int = 4) -> DgradPlan:
    """What a launch of the tiles ``blk`` runs over ``n`` images of an
    unpadded ``hi x wi`` input with leading pads ``pads``, with
    ``op_bytes`` operands."""
    (pt, _), (pl, _) = pads
    tiles = dgrad_tiles(blk, hi, wi, hf, wf, stride, pads)
    cells = sum(r.extent * c.extent * r.taps * c.taps
                for r in dgrad_phase_axes(hi, hf, stride, pt)
                for c in dgrad_phase_axes(wi, wf, stride, pl))
    tile_taps = sum(r.taps * c.taps for r, c, _, _ in tiles)
    kpad = fwd_kpad(cob, op_bytes)
    products = 3 if op_bytes == 4 else 1
    return DgradPlan(
        tiles=len(tiles),
        function_macs=n * ciblk * cells * cib * coblk * cob,
        issued_macs=(n * ciblk * tile_taps * DGRAD_ROWS * blk.wgs * blk.lanes
                     * coblk * kpad * products),
        products=products)


def dgrad_candidates(n: int, hi: int, wi: int, hf: int, wf: int,
                     stride: int, ciblk: int, cib: int, cob: int,
                     machine: MachineModel, prologue: bool, streamed: bool,
                     hso: int | None = None, op_bytes: int = 4):
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
    bf16 build: chunks of k16 slices, 2-byte cells, one product a MAC at
    twice the TF32 rate, and no weight split."""
    lanes = dgrad_lanes(cib)
    step = _fwd_k_step(op_bytes)
    bf16 = step == 16
    mh, mw = -(-hf // stride), -(-wf // stride)
    hp, wp = -(-hi // stride), -(-wi // stride)
    kpad = fwd_kpad(cob, op_bytes)
    chunks = [c for c in range(kpad, 0, -step) if kpad % c == 0]
    out = []
    counts = range(2, DGRAD_CONSUMERS + 1) if streamed else range(
        1, DGRAD_CONSUMERS + 1)
    for wgs in counts:
        if bf16 and lanes == DGRAD_LANES[-1] and wgs > BF16_WIDE_CONSUMERS:
            continue
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
            hwin, wwin = th + mh - 1, tw + mw - 1
            chunk = next((c for c in chunks if dgrad_smem_bytes(
                hf, wf, stride, lanes, c, hwin, wwin, prologue, streamed,
                op_bytes) <= machine.smem_block), None)
            if chunk is None:
                continue
            tiles = stride * stride * -(-hp // th) * -(-wp // tw)
            taps = hf * wf / (stride * stride)    # a phase's, on average
            mma = ((1 if bf16 else 3) * rows * taps * chunk * lanes
                   / (DGRAD_MACS_PER_CYCLE * (2 if bf16 else 1))
                   / DGRAD_WG_EFFICIENCY[wgs])
            cells = hwin * wwin * chunk
            other = DGRAD_STAGE_CYCLES + (
                (0 if bf16 else DGRAD_SPLIT_CYCLES * taps * chunk * lanes)
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


def _dgrad_blocking(n: int, hi: int, wi: int, hf: int, wf: int, stride: int,
                    ciblk: int, cib: int, cob: int, machine: MachineModel,
                    prologue: bool, streamed: bool, hso: int | None,
                    what: str, op_bytes: int = 4) -> DgradBlocking:
    """The least-cost tile of ``dgrad_candidates``."""
    found = dgrad_candidates(n, hi, wi, hf, wf, stride, ciblk, cib, cob,
                             machine, prologue, streamed, hso, op_bytes)
    if not found:
        if hso is not None and hso > DGRAD_ROWS:
            raise ValueError(f"hso={hso} phase rows do not fit a strip of "
                             f"at most {DGRAD_ROWS} positions")
        raise SmemMisfitError(
            f"no {what} tile fits: filter {hf}x{wf}, stride {stride}, "
            f"cib={cib}, cob={cob} need more than {machine.smem_block} bytes "
            "of shared memory even at one position")
    return min(found, key=lambda kb: kb[0])[1]


@functools.lru_cache(maxsize=4096)
def choose_dgrad_blocking(n: int, hi: int, wi: int, hf: int, wf: int,
                          stride: int, ciblk: int, cib: int, cob: int,
                          machine: MachineModel = H100_SXM,
                          prologue: bool = False,
                          op_bytes: int = 4) -> DgradBlocking:
    """Tile the window dgrad of ``n`` images over an unpadded ``hi x wi``
    input (``_dgrad_blocking``): a CTA stages the whole cotangent window of
    its ``th x tw`` tile a stage, with ``z`` beside it when ``prologue``;
    ``op_bytes`` 2 for the bf16 build."""
    return _dgrad_blocking(n, hi, wi, hf, wf, stride, ciblk, cib, cob,
                           machine, prologue, False, None, "dgrad", op_bytes)


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


def wgrad_ldx(cib: int, stride: int, op_bytes: int = 4) -> int:
    """Elements of one staged x cell (``wgrad_tile::x_ld``): ``cib`` rounded
    up to 4, then up to the first value whose ``stride`` multiple is 8 mod
    16, so that an A load's four positions start on four distinct 8-bank
    groups (``cib`` rounded up to 4 where no such value exists).  bf16
    (``op_bytes`` 2, ``wgrad_tile::bf16::x_ld``): rounded up to 8 (a TMA
    box's 16 bytes), then likewise in steps of 8."""
    unit = 4 if op_bytes == 4 else 8
    base = -(-cib // unit) * unit
    return next((ld for ld in range(base, base + 8 * unit, unit)
                 if stride * ld % 16 == 8), base)


def wgrad_mtiles(hf: int, wf: int, cib: int) -> int:
    """64-row m-tiles of the ``hf * wf * cib`` (tap, c) rows."""
    return -(-hf * wf * cib // WGRAD_ROWS)


def wgrad_smem_bytes(th: int, tw: int, hf: int, wf: int, stride: int,
                     cib: int, cob: int, lanes: int, prologue: bool,
                     op_bytes: int = 4) -> int:
    """Dynamic shared memory of one wgrad CTA (``wgrad_tile::smem_bytes``):
    128 bytes to align the base; per slot of the two-slot ring the x window
    ``[hwin][rf]`` (a row's ``wwin`` cells of ``ld`` floats, padded to 128
    bytes, where its TMA box lands), the staged ``g`` (and ``z``)
    ``[K][Cob]`` rounded up to 128 bytes, and B's big and small halves
    ``[K/4][lanes][4]`` (K = th * tw rounded up to 8); the position offsets,
    the db partials and two 8-byte mbarriers a slot.

    bf16 (``op_bytes`` 2, ``wgrad_tile::bf16::smem_bytes``): 2-byte cells
    (``wgrad_ldx`` at 2 bytes), rows padded to 128 bytes, K rounded up to
    16, and B one ``[lanes/8][K + 1][8]`` bf16 buffer (no small half; a
    position of padding a lane group), rounded up to 128 bytes."""
    hwin, wwin = (th - 1) * stride + hf, (tw - 1) * stride + wf
    if op_bytes == 2:
        kpos = -(-th * tw // 16) * 16
        x = hwin * -(-wwin * wgrad_ldx(cib, stride, 2) // 64) * 64
        raw = -(-kpos * cob // 64) * 64
        slot = (x + (2 if prologue else 1) * raw
                + -(-(kpos + 1) * lanes // 64) * 64)
        return 128 + 2 * 2 * slot + 4 * (WGRAD_MAX_POSITIONS + 128) + 8 * 4
    kpos = -(-th * tw // 8) * 8
    x = hwin * -(-wwin * wgrad_ldx(cib, stride) // 32) * 32
    raw = -(-kpos * cob // 32) * 32
    slot = x + (2 if prologue else 1) * raw + 2 * kpos * lanes
    return 128 + 4 * (2 * slot + WGRAD_MAX_POSITIONS + 128) + 8 * 4


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
               cob: int, prologue: bool) -> WgradPlan:
    """What a launch of the tiles ``blk`` runs over ``n`` images of an
    ``ho x wo`` output (the bf16 build where ``blk.kstep`` is 16)."""
    op_bytes = 2 if blk.kstep == 16 else 4
    products = 3 if op_bytes == 4 else 1
    return WgradPlan(
        tiles=blk.tiles,
        function_macs=n * ho * wo * hf * wf * cib * ciblk * cob * coblk,
        issued_macs=(ciblk * coblk * blk.tiles * blk.kpos
                     * wgrad_mtiles(hf, wf, cib) * WGRAD_ROWS * blk.lanes
                     * products),
        smem=wgrad_smem_bytes(blk.th, blk.tw, hf, wf, stride, cib, cob,
                              blk.lanes, prologue, op_bytes),
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
                     hso: int | None = None, op_bytes: int = 4):
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
    stages.  ``op_bytes`` 2 weighs the bf16 build: K in k16 slices, 2-byte
    staging, one product a MAC at twice the TF32 rate."""
    lanes = wgrad_lanes(cob)
    kstep = _fwd_k_step(op_bytes)
    bf16 = kstep == 16
    mt = wgrad_mtiles(hf, wf, cib)
    cols = coblk * ciblk * hf * wf * cib * cob + coblk * cob
    cls = StreamWgradBlocking if streamed else WgradBlocking
    out = []
    for th, tw in _wgrad_shapes(ho, wo, hso):
        smem = wgrad_smem_bytes(th, tw, hf, wf, stride, cib, cob, lanes,
                                prologue, op_bytes)
        if smem > machine.smem_block:
            continue
        kpos = -(-th * tw // kstep) * kstep
        hwin, wwin = (th - 1) * stride + hf, (tw - 1) * stride + wf
        tiles = n * -(-ho // th) * -(-wo // tw)
        # the streamed walk's kept halo rows cost its producer a move in
        # shared memory, as much as their TMA copy from L2 costs the window
        # kernel's: both stage the whole window
        staged = op_bytes * (hwin * wwin * cib
                             + th * tw * cob * (2 if prologue else 1))
        producer = (WGRAD_STAGE_CYCLES + staged / WGRAD_BYTES_PER_CYCLE
                    + kpos * lanes / 128 * WGRAD_TRANSFORM_CYCLES)
        for wgs in range(1, WGRAD_CONSUMERS + 1):
            for mpw in WGRAD_MPW:
                if (lanes * mpw > 128 or (mpw > 1 and mt == 1)
                        or (wgs - 1) * mpw >= mt
                        or (bf16 and lanes * mpw == 128
                            and wgs > BF16_WIDE_CONSUMERS)):
                    continue
                groups = -(-mt // (wgs * mpw))
                column = min(hf * wf * cib, wgs * mpw * WGRAD_ROWS) * cob
                mma = (mt / groups * kpos / 8 * (1 if bf16 else 3)
                       * WGRAD_ROWS * lanes * 8
                       / (WGRAD_MACS_PER_CYCLE * (2 if bf16 else 1))
                       / WGRAD_WG_EFFICIENCY[wgs])
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


def _wgrad_blocking(n, ho, wo, hf, wf, stride, ciblk, cib, coblk, cob,
                    machine, prologue, streamed, hso, what, op_bytes=4):
    """The least-cost tile of ``wgrad_candidates``."""
    found = wgrad_candidates(n, ho, wo, hf, wf, stride, ciblk, cib, coblk,
                             cob, machine, prologue, streamed, hso, op_bytes)
    if not found:
        raise SmemMisfitError(
            f"no {what} fits: cib={cib}, cob={cob}, filter {hf}x{wf}, "
            f"stride {stride} needs more than {machine.smem_block} bytes of "
            "shared memory even at one position")
    return min(found, key=lambda kb: kb[0])[1]


@functools.lru_cache(maxsize=4096)
def choose_wgrad_blocking(n: int, ho: int, wo: int, hf: int, wf: int,
                          stride: int, ciblk: int, cib: int, coblk: int,
                          cob: int, machine: MachineModel = H100_SXM,
                          prologue: bool = False,
                          op_bytes: int = 4) -> WgradBlocking:
    """Tile the window weight gradient of ``n`` images over an ``ho x wo``
    output (``wgrad_candidates``): each stage stages a tile's whole x
    window, with ``z`` beside its ``g`` when ``prologue``; ``op_bytes`` 2
    for the bf16 build."""
    return _wgrad_blocking(n, ho, wo, hf, wf, stride, ciblk, cib, coblk, cob,
                           machine, prologue, False, None, "wgrad tile",
                           op_bytes)


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


@dataclasses.dataclass(frozen=True)
class PointwiseBlocking:
    """Launch parameters of the pointwise forward's tile.  A CTA of
    ``wgs`` consumer warpgroups owns ``rows = 64 * wgs`` consecutive
    positions of one image (``tiles`` an image, the last one ragged) by
    ``lanes`` output lanes (the wgmma width; an output block splits into
    ``nsplit`` CTAs), and contracts ``chunk`` channels a stage."""
    rows: int
    wgs: int
    lanes: int
    nsplit: int
    chunk: int
    tiles: int


def pointwise_smem_bytes(rows: int, chunk: int, lanes: int, wgs: int,
                         gap: bool = False) -> int:
    """Dynamic shared memory of one pointwise tile CTA (the kernel's
    ``smem_bytes``): 128 bytes to align the base; per slot of its
    two-slot ring the input rows ``[rows][chunk + 4]``, the raw weight
    chunk ``[chunk][lanes]`` and its TF32 halves; an int per k8 step; with
    ``gap`` the consumer warps' ``[4 * wgs][lanes]`` sums."""
    return 128 + 4 * (PW_SLOTS * (rows * (chunk + 4) + 3 * chunk * lanes)
                      + chunk // 8 + (4 * wgs * lanes if gap else 0))


def pointwise_candidates(n: int, hw: int, kblk: int, kw: int, oblk: int,
                         ow: int, machine: MachineModel = H100_SXM,
                         gap: bool = False):
    """The tiles the search weighs, each as ``(key, PointwiseBlocking)``,
    the least key the choice (see the constants above); ties go to a
    larger chunk, more rows, then fewer splits."""
    kpad = -(-kw // 8) * 8
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
                rows, c, lanes, wgs, gap) <= machine.smem_block), None)
            if chunk is None:
                continue
            stages = kblk * kpad // chunk
            ctas = n * tiles * oblk * nsplit
            mma = (3 * rows * chunk * lanes / DGRAD_MACS_PER_CYCLE
                   / DGRAD_WG_EFFICIENCY[wgs])
            copies = (rows * chunk + chunk * lanes) / 4
            other = PW_STAGE_CYCLES + (
                PW_COPY_CYCLES * copies + PW_SPLIT_CYCLES * chunk * lanes
            ) / 128
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
                              gap: bool = False) -> PointwiseBlocking:
    """Tile a channel matmul over ``n`` images of ``hw`` positions that
    contracts ``kblk`` input pencils of ``kw`` channels into ``oblk``
    output pencils of ``ow`` lanes: the least-cost tile of
    ``pointwise_candidates``."""
    if hw <= 0 or n <= 0:
        raise ValueError(f"empty map: n={n}, hw={hw}")
    found = pointwise_candidates(n, hw, kblk, kw, oblk, ow, machine, gap)
    if not found:
        raise SmemMisfitError(
            f"no pointwise tile fits: kw={kw}, ow={ow} need more than "
            f"{machine.smem_block} bytes of shared memory at 64 rows")
    return min(found, key=lambda kb: kb[0])[1]


def pointwise_issued_macs(blk: PointwiseBlocking, n: int, kblk: int,
                          kw: int, oblk: int) -> int:
    """The tensor-core MACs a launch of ``blk`` issues: every CTA's whole
    ``rows x lanes`` tile over K padded to whole chunks in every input
    block, three products each."""
    kpad = -(-kw // 8) * 8
    return (3 * n * blk.tiles * oblk * blk.nsplit * blk.rows * blk.lanes
            * kblk * (-(-kpad // blk.chunk) * blk.chunk))


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


def depthwise_fwd_smem_bytes(hwin: int, wwin: int, lanes: int,
                             machine: MachineModel = H100_SXM,
                             gap: bool = False) -> int:
    """The forward's two staged f32 windows (each rounded up to 16 bytes)
    and with ``gap`` the ``[position groups, lanes]`` sums beside them."""
    stage = 2 * _round4(hwin * wwin * lanes)
    if gap:
        stage += (machine.threads // lanes) * lanes
    return 4 * stage


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
                              gap: bool = False) -> DepthwiseBlocking:
    """Tile the depthwise forward over its ``ho x wo`` output
    (``_depthwise_items``): a tile's window is its halo'd input, two of
    them (and with ``gap`` the position groups' sums) in a CTA's shared
    memory."""
    return _depthwise_items(
        n, cblk, ho, wo, cb,
        lambda hob, wob: halo_dims(hob, wob, hf, wf, stride, dilation),
        lambda hob, wob, hwin, wwin, lanes: depthwise_fwd_smem_bytes(
            hwin, wwin, lanes, machine, gap),
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
                               prologue: bool) -> int:
    """The dgrad's ring: two slots, each the cotangent window ``[hwin, wwin,
    lanes]`` (rounded up to 16 bytes), and with the prologue the window of
    ``z`` beside it."""
    return 4 * 2 * (2 if prologue else 1) * _round4(hwin * wwin * lanes)


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
                                    machine: MachineModel = H100_SXM
                                    ) -> DepthwiseBlocking:
    """Tile the depthwise dgrad over the unpadded ``hi x wi`` input
    (``_depthwise_items``): an item is a tile of dx, its window the
    cotangent cells that feed it (``depthwise_dgrad_window``, under the
    forward's ``pads``, SAME's at a 3x3 filter by default), two of them
    (with the ``prologue``, with ``z`` beside each) in a CTA's shared
    memory."""
    return _depthwise_items(
        n, cblk, hi, wi, cb,
        lambda hob, wob: depthwise_dgrad_window(hob, wob, hi, wi, hf, wf,
                                                stride, dilation, pads),
        lambda hob, wob, hwin, wwin, lanes: depthwise_dgrad_smem_bytes(
            hwin, wwin, lanes, prologue),
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
                               machine: MachineModel = H100_SXM) -> int:
    """The wgrad's ring: two slots, each an item's x window ``[hwin, wwin,
    lanes]`` and its g tile ``[hob, wob, lanes]`` (with the prologue z's
    beside it), each rounded up to 16 bytes; or the position groups'
    ``[threads / lanes, taps + 1, lanes]`` sums where those are larger
    (they reuse the ring once the walk is done)."""
    slot = _round4(hwin * wwin * lanes) \
        + (2 if prologue else 1) * _round4(hob * wob * lanes)
    red = (machine.threads // lanes) * (taps + 1) * lanes
    return 4 * max(2 * slot, red)


@functools.lru_cache(maxsize=4096)
def choose_depthwise_wgrad_blocking(n: int, cblk: int, ho: int, wo: int,
                                    cb: int, hf: int, wf: int,
                                    stride: int = 1, dilation=(1, 1),
                                    prologue: bool = True,
                                    machine: MachineModel = H100_SXM
                                    ) -> DepthwiseWgradBlocking:
    """Tile the depthwise weight gradient as the forward's items
    (``_depthwise_items``) over its ``ho x wo`` output: a tile's window is
    its halo'd input, staged with its g (and with the ``prologue`` z) tile,
    two items' worth (or the position groups' sums) in a CTA's shared
    memory.  Each column's items go to as many contiguous shares as one
    wave of CTAs holds, or one CTA an SM where that would give a column's
    summing CTA too many rows (``_splits``)."""
    window, smem = _depthwise_wgrad_rules(hf, wf, stride, dilation,
                                          prologue, machine)
    items = _depthwise_items(
        n, cblk, ho, wo, cb, window, smem, machine,
        f"depthwise wgrad tile (filter {hf}x{wf}, stride {stride}, "
        f"dilation {tuple(dilation)})")
    return _depthwise_wgrad_shares(n, cblk, ho, wo, cb, items.hob,
                                   items.wob, items.hwin, items.wwin,
                                   items.lanes, hf * wf, machine)


def _depthwise_wgrad_rules(hf: int, wf: int, stride: int, dilation,
                           prologue: bool, machine: MachineModel):
    """The wgrad's ``window`` and ``smem`` rules for ``_depthwise_fits``."""
    taps = hf * wf
    if taps > DW_MAX_TAPS:
        raise ValueError(f"filter {hf}x{wf} has more than {DW_MAX_TAPS} taps")
    dilation = tuple(dilation)
    return (lambda hob, wob: halo_dims(hob, wob, hf, wf, stride, dilation),
            lambda hob, wob, hwin, wwin, lanes: depthwise_wgrad_smem_bytes(
                hwin, wwin, hob, wob, lanes, taps, prologue, machine))


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
                               machine: MachineModel = H100_SXM
                               ) -> list[DepthwiseWgradBlocking]:
    """Every item the wgrad's chooser weighs, with its shares
    (``launch/separable_bwd_ab.py`` times them)."""
    window, smem = _depthwise_wgrad_rules(hf, wf, stride, dilation,
                                          prologue, machine)
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


def _round4(n: int) -> int:
    return -(-n // 4) * 4


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
