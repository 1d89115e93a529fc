"""Analytical blocking model of the direct-conv kernels, fitted to one Hopper CTA.

The reference (``repro/core/blocking.py``) fits a Pallas grid step against
TPU VMEM.  On the H100 the scarce resources of one CTA are different:

* the **register tile**: each of the kernel's ``threads`` threads keeps an
  f32 accumulator of ``positions`` output positions x ``lanes`` output
  channels, so one CTA holds at most
  ``(threads // ceil(Cob / lanes)) * positions`` output positions of a
  ``Cob`` pencil;
* **shared memory**: per step of the Ci loop the CTA stages the halo'd
  input window ``[Hib, Wib, chunk]`` and the weight chunk ``[Hf, Wf, chunk,
  Cob]`` (f32), where ``chunk`` divides the ``Cib`` pencil.  An H100 block
  may use up to 227 KB, above 48 KB only after ``cudaFuncSetAttribute``
  (the kernel's C entry point sets it per launch).  The budget below is
  96 KB so that two CTAs share one SM, as the kernel's launch bound
  (two CTAs of 256 threads, at most 128 registers each) asks.

Every chooser is a pure function of its arguments and is cached by them,
so a layer pays for its search once, not at every launch.

The reference's rules are kept: ``hob``/``wob`` divide ``Ho``/``Wo`` (so a
tile never straddles the map's edge) and the tile shrinks rows first, then
columns.  Where the reference halves a dim until it fits, this model takes
the largest divisor that fits, which is never smaller.  ``MachineModel``'s
``threads``/``lanes``/``positions`` must equal the compiled kernels'
constants; the kernel wrappers check them against the built libraries.

The separable family has choosers of its own: ``choose_pointwise_blocking``
(the channel matmul of ``csrc/conv2d_pointwise.cu``, forward and dgrad),
``choose_pointwise_wgrad_blocking``, ``choose_depthwise_blocking`` (the
tap kernel of ``csrc/conv2d_depthwise.cu``, forward and dgrad) and
``choose_depthwise_wgrad_blocking``.  Each sizes its CTA tile so that the
grid fills the card where the map allows it (``MachineModel.wave``), and
the wgrads split their position reductions as the dense wgrad does.

The streamed (halo-ring) kernels of ``csrc/conv2d_stream.cu`` have choosers
of their own (``choose_stream_blocking``, ``choose_stream_dgrad_blocking``,
``choose_stream_wgrad_blocking``; see their section below).  Every chooser
raises ``SmemMisfitError`` when nothing fits.

The backward kernels (``csrc/direct_conv2d_bwd.cu``) reuse the vocabulary:

* **dgrad** (``choose_dgrad_blocking``) is the forward's schedule on the
  input grid: a CTA owns a ``hob x wob`` tile of the *unpadded* input
  gradient and the Cib pencil as its register-tile lanes, and contracts the
  Cob pencil.  It stages a window of the cotangent in its own coordinates
  (``dgrad_window``; at stride 2 a dx tile reaches about half as many
  cotangent rows) plus a transposed weight chunk ``[Hf*Wf, chunk, Cib]``.
* **wgrad** (``choose_wgrad_blocking``) gives each CTA a few taps'
  ``[Cib, Cob]`` blocks as its register tile and a share of the
  ``N x Ho/Hob x Wo/Wob`` position tiles; the shares' partial sums go to a
  workspace that a second pass reduces in split order.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.core.conv2d_common import halo_dims
from repro_torch.core.errors import TransientError
from repro_torch.core.layout import divisors

__all__ = ["SmemMisfitError", "MachineModel", "H100_SXM", "Blocking",
           "tile_positions",
           "smem_bytes", "choose_blocking", "dgrad_extents", "dgrad_window",
           "DgradBlocking", "dgrad_smem_bytes", "choose_dgrad_blocking",
           "WgradBlocking", "wgrad_smem_bytes", "choose_wgrad_blocking",
           "PointwiseBlocking", "pointwise_smem_bytes",
           "choose_pointwise_blocking", "PointwiseWgradBlocking",
           "pointwise_wgrad_smem_bytes", "choose_pointwise_wgrad_blocking",
           "DW_MAX_TAPS", "DW_THREAD_POSITIONS", "DepthwiseBlocking", "depthwise_smem_bytes",
           "choose_depthwise_blocking", "DepthwiseWgradBlocking",
           "depthwise_wgrad_smem_bytes", "choose_depthwise_wgrad_blocking",
           "STREAM_STRIPS", "StreamBlocking", "stream_ring_rows",
           "stream_gap_floats",
           "stream_smem_bytes",
           "choose_stream_blocking", "choose_stream_dgrad_blocking",
           "StreamWgradBlocking", "stream_wgrad_smem_bytes",
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
    threads: int          # threads per CTA (the kernel's kThreads)
    lanes: int            # output channels in one thread's register tile
    positions: int        # output positions in one thread's register tile
    smem_budget: int      # shared-memory bytes one CTA may stage
    sms: int = 132        # streaming multiprocessors
    ctas_per_sm: int = 2  # resident CTAs the kernels' launch bounds ask for

    @property
    def wave(self) -> int:
        """CTAs the card holds at once: the grid size that fills it."""
        return self.sms * self.ctas_per_sm


H100_SXM = MachineModel(
    name="h100_sxm", threads=256, lanes=8, positions=8,
    smem_budget=96 * 1024, sms=132, ctas_per_sm=2)


@dataclasses.dataclass(frozen=True)
class Blocking:
    """Launch parameters of one forward conv."""
    cob: int     # output-channel pencil (one CTA's channel block)
    cib: int     # input-channel pencil (one step of the CTA's Ci loop)
    hob: int     # output rows per CTA tile
    wob: int     # output cols per CTA tile
    chunk: int   # input channels staged in shared memory at once


def tile_positions(cob: int, machine: MachineModel) -> int:
    """Output positions one CTA's register tile holds for a ``cob`` pencil."""
    groups = -(-cob // machine.lanes)
    if groups > machine.threads:
        raise SmemMisfitError(
            f"cob={cob} needs {groups} channel groups; a CTA has "
            f"{machine.threads} threads")
    return (machine.threads // groups) * machine.positions


def smem_bytes(hob: int, wob: int, chunk: int, cob: int, hf: int, wf: int,
               stride: int, machine: MachineModel, gap: bool = False) -> int:
    """Dynamic shared memory of one CTA: the staged f32 window and weight
    chunk; with ``gap`` at least the f32 ``[position groups, Cob]`` scratch
    of the pooled partial sums (it reuses the staging buffer)."""
    hib, wib = halo_dims(hob, wob, hf, wf, stride)
    stage = (hib * wib * chunk + hf * wf * chunk * cob) * 4
    if gap:
        groups = -(-cob // machine.lanes)
        stage = max(stage, (machine.threads // groups) * cob * 4)
    return stage


def _fit_tile(ho: int, wo: int, cap: int, pencil: int, stage, budget: int,
              what: str):
    """The largest ``(h, w)`` tile of an ``ho x wo`` grid (rows first, then
    columns; divisors only) that fits ``cap`` register-tile positions and
    ``stage(h, w, chunk=1) <= budget`` bytes, then the largest ``chunk``
    dividing ``pencil`` that still fits.  -> ``(h, w, chunk)``."""

    def fits(h: int, w: int, chunk: int = 1) -> bool:
        return h * w <= cap and stage(h, w, chunk) <= budget

    def largest_fitting(extent: int, fit) -> int | None:
        return next((d for d in reversed(divisors(extent)) if fit(d)), None)

    h, w = largest_fitting(ho, lambda d: fits(d, wo)), wo
    if h is None:                       # one row still too wide: tile columns
        h, w = 1, largest_fitting(wo, lambda d: fits(1, d))
    if w is None:
        raise SmemMisfitError(
            f"no tile fits the {what}: needs more than {budget} bytes of "
            f"shared memory or {cap} register-tile positions even at 1x1")
    return h, w, largest_fitting(pencil, lambda c: fits(h, w, c))


@functools.lru_cache(maxsize=4096)
def choose_blocking(hi: int, wi: int, ci: int, co: int, hf: int, wf: int,
                    stride: int, cob: int, cib: int,
                    machine: MachineModel = H100_SXM,
                    gap: bool = False) -> Blocking:
    """Pick (Hob, Wob, chunk) for a VALID conv over a padded ``hi x wi``
    input (the kernel masks the pads instead of copying), with the channel
    pencils ``cob``/``cib`` of the operands' layout.

    The tile is the whole map if it fits the register tile and shared
    memory; else the largest row count that divides ``Ho`` and fits; else
    (at one row) the largest column count that divides ``Wo``.  ``chunk``
    is then the largest divisor of ``cib`` whose staging fits the budget.
    """
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output for input {hi}x{wi}, filter {hf}x{wf}")
    if co % cob or ci % cib:
        raise ValueError(f"pencils cob={cob}/cib={cib} must divide "
                         f"co={co}/ci={ci}")
    h, w, chunk = _fit_tile(
        ho, wo, tile_positions(cob, machine), cib,
        lambda h, w, c: smem_bytes(h, w, c, cob, hf, wf, stride, machine, gap),
        machine.smem_budget,
        f"forward conv (filter {hf}x{wf}, stride {stride}, cob={cob})")
    return Blocking(cob=cob, cib=cib, hob=h, wob=w, chunk=chunk)


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


@dataclasses.dataclass(frozen=True)
class DgradBlocking:
    """Launch parameters of one dgrad: a ``hob x wob`` tile of the unpadded
    input gradient per CTA, the Cob pencil contracted ``chunk`` channels at
    a time over a ``hwin x wwin`` cotangent window; the staged weight chunk
    ``[Hf*Wf, chunk, ldw]`` pads each Cib row to ``ldw`` floats."""
    hob: int
    wob: int
    chunk: int
    hwin: int
    wwin: int
    ldw: int


def _dgrad_ldw(cib: int) -> int:
    # the staged weight is written transposed (channel runs of cob become
    # columns of cib): four floats of padding spread a column over the
    # banks and keep the float4 reads of a row aligned
    return cib + 4 if cib % 4 == 0 else cib


def dgrad_smem_bytes(hob: int, wob: int, chunk: int, cib: int, hf: int,
                     wf: int, stride: int) -> int:
    """Dynamic shared memory of one dgrad CTA: the f32 weight chunk, the
    cotangent window, and one zero run of ``chunk`` floats that the taps a
    stride skips read instead of the window."""
    hwin, wwin = dgrad_window(hob, wob, hf, wf, stride)
    return 4 * (hf * wf * chunk * _dgrad_ldw(cib) + hwin * wwin * chunk
                + chunk)


@functools.lru_cache(maxsize=4096)
def choose_dgrad_blocking(hi: int, wi: int, hf: int, wf: int, stride: int,
                          cib: int, cob: int,
                          machine: MachineModel = H100_SXM) -> DgradBlocking:
    """Tile the input gradient of a conv over an unpadded ``hi x wi`` input
    with the forward's rules, the pencils' roles swapped: the register
    tile's lanes are Cib, the contraction chunk divides Cob."""
    h, w, chunk = _fit_tile(
        hi, wi, tile_positions(cib, machine), cob,
        lambda h, w, c: dgrad_smem_bytes(h, w, c, cib, hf, wf, stride),
        machine.smem_budget,
        f"dgrad (filter {hf}x{wf}, stride {stride}, cib={cib})")
    hwin, wwin = dgrad_window(h, w, hf, wf, stride)
    return DgradBlocking(hob=h, wob=w, chunk=chunk, hwin=hwin, wwin=wwin,
                         ldw=_dgrad_ldw(cib))


# ---------------------------------------------------------------------------
# weight gradient (wgrad)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WgradBlocking:
    """Launch parameters of one wgrad.

    A CTA holds ``taps`` filter taps' ``[Cib, Cob]`` blocks in its register
    tile (``tap_groups`` CTAs cover the filter) and walks a contiguous share
    of the ``tiles`` position tiles (``hob x wob`` outputs of one image
    each); ``splits`` shares per (tap group, Co block, Ci block).  The
    partial sums fill a ``[splits, |dw| + |db|]`` f32 workspace."""
    hob: int
    wob: int
    taps: int
    tap_groups: int
    tiles: int
    splits: int


def wgrad_smem_bytes(hob: int, wob: int, cib: int, cob: int, hf: int,
                     wf: int, stride: int) -> int:
    """Dynamic shared memory of one wgrad CTA: the halo'd f32 input window
    ``[Hib, Wib, Cib]``, rounded up to 16 bytes, and the cotangent tile
    ``[hob * wob, Cob]``."""
    hib, wib = halo_dims(hob, wob, hf, wf, stride)
    return 4 * (-(-hib * wib * cib // 4) * 4 + hob * wob * cob)


# Position tiles of the wgrad: one staging step per tile, so larger tiles
# amortize the CTA's barriers; past a few hundred positions the window and
# the cotangent tile no longer fit two CTAs per SM at 128 x 128 anyway.
WGRAD_MAX_POSITIONS = 256


@functools.lru_cache(maxsize=4096)
def choose_wgrad_blocking(n: int, ho: int, wo: int, hf: int, wf: int,
                          stride: int, ciblk: int, cib: int, coblk: int,
                          cob: int, machine: MachineModel = H100_SXM
                          ) -> WgradBlocking:
    """Tile the weight gradient.

    * taps: each thread holds ``lanes x lanes`` (Cib x Cob) sums, so one
      tap's block takes ``ceil(Cib/lanes) * ceil(Cob/lanes)`` threads and a
      CTA holds as many taps as its threads cover (one at 128 x 128);
    * the position tile: the ``hob x wob`` (dividing ``Ho x Wo``) with the
      most positions, up to ``WGRAD_MAX_POSITIONS``, whose window and
      cotangent tile fit the shared-memory budget; ties go to the smaller
      window;
    * splits: enough position shares that the grid holds
      ``ctas_per_sm * sms`` CTAs twice over, never more shares than tiles.
      The workspace is then ``splits * (|dw| + |db|)`` floats with
      ``splits <= ceil(2 * ctas_per_sm * sms / base)``, ``base`` being the
      grid without splits.
    """
    lanes, threads = machine.lanes, machine.threads
    groups = -(-cib // lanes) * -(-cob // lanes)
    if groups > threads:
        raise SmemMisfitError(
            f"cib={cib} x cob={cob} needs {groups} thread "
            f"groups; a CTA has {threads} threads")
    taps = min(hf * wf, threads // groups)
    tap_groups = -(-hf * wf // taps)
    best = None
    for h in divisors(ho):
        for w in divisors(wo):
            if h * w > WGRAD_MAX_POSITIONS:
                continue
            smem = wgrad_smem_bytes(h, w, cib, cob, hf, wf, stride)
            if smem > machine.smem_budget:
                continue
            key = (h * w, -smem)
            if best is None or key > best[0]:
                best = (key, h, w)
    if best is None:
        raise SmemMisfitError(
            f"no wgrad tile fits: cib={cib}, cob={cob}, filter {hf}x{wf}, "
            f"stride {stride} needs more than {machine.smem_budget} bytes of "
            "shared memory even at 1x1")
    _, h, w = best
    tiles = n * (ho // h) * (wo // w)
    splits = _splits(tiles, tap_groups * ciblk * coblk, machine)
    return WgradBlocking(hob=h, wob=w, taps=taps, tap_groups=tap_groups,
                         tiles=tiles, splits=splits)


def _splits(tiles: int, base: int, machine: MachineModel) -> int:
    """Position shares of a split reduction: enough that the grid holds the
    card's resident CTAs twice over, never more shares than tiles."""
    return max(1, min(tiles, -(-2 * machine.wave // base)))


# ---------------------------------------------------------------------------
# pointwise (1x1, stride 1): the channel matmul
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PointwiseBlocking:
    """Launch parameters of the channel-matmul kernel (the pointwise forward,
    and its dgrad with the pencils' roles swapped).  A CTA computes
    ``positions`` consecutive positions of one image for the whole output
    pencil, contracting the input pencils ``chunk`` channels at a time;
    each image has ``tiles`` position tiles, the last one ragged.  The
    staged input rows are ``ldx`` floats apart, the staged weight rows
    ``ldw`` (padded when the dgrad writes them transposed)."""
    positions: int
    chunk: int
    tiles: int
    ldx: int
    ldw: int


def _pad_row(n: int) -> int:
    # four floats of padding move neighbouring staged rows four banks
    # apart and keep a row's float4 accesses aligned
    return n + 4 if n % 4 == 0 else n


def pointwise_smem_bytes(positions: int, chunk: int, ob: int,
                         machine: MachineModel = H100_SXM,
                         gap: bool = False, transposed: bool = False) -> int:
    """Dynamic shared memory of one channel-matmul CTA: the staged weight
    chunk ``[chunk, ldw]`` and input rows ``[positions, ldx]`` (f32); with
    ``gap`` at least the ``[position groups, ob]`` partial sums."""
    ldw = _pad_row(ob) if transposed else ob
    stage = 4 * (chunk * ldw + positions * _pad_row(chunk))
    if gap:
        stage = max(stage, 4 * (machine.threads // -(-ob // machine.lanes))
                    * ob)
    return stage


@functools.lru_cache(maxsize=4096)
def choose_pointwise_blocking(n: int, hw: int, kb: int, oblk: int, ob: int,
                              machine: MachineModel = H100_SXM,
                              gap: bool = False, transposed: bool = False
                              ) -> PointwiseBlocking:
    """Tile a channel matmul over ``n`` images of ``hw`` positions with an
    input pencil ``kb`` (the contraction) and ``oblk`` output pencils of
    ``ob`` lanes; ``transposed`` for the dgrad, which stages the weight
    transposed.

    A thread holds 8, 4 or 2 positions of 8 lanes (the kernel is compiled
    for each), so a CTA tile is that many times its position groups, or
    the whole map when it is smaller.  The largest tile whose grid ``n *
    tiles * oblk`` still fills the card (``machine.wave`` CTAs) is taken;
    where none does, as on 7x7 and 14x14 maps, two positions a thread, the
    fewest that keep the FMAs ahead of the shared-memory reads.  ``chunk``
    is then the largest divisor of ``kb`` that fits the budget.
    """
    if hw <= 0 or n <= 0:
        raise ValueError(f"empty map: n={n}, hw={hw}")
    groups = tile_positions(ob, machine) // machine.positions
    sizes = [min(hw, groups * k) for k in (8, 4, 2)]
    positions = next((p for p in sizes
                      if n * -(-hw // p) * oblk >= machine.wave), sizes[-1])
    chunk = next((c for c in reversed(divisors(kb))
                  if pointwise_smem_bytes(positions, c, ob, machine, gap,
                                          transposed)
                  <= machine.smem_budget), None)
    if chunk is None:
        raise SmemMisfitError(
            f"no channel chunk fits: {positions} positions x ob={ob} need "
            f"more than {machine.smem_budget} bytes of shared memory")
    return PointwiseBlocking(
        positions=positions, chunk=chunk, tiles=-(-hw // positions),
        ldx=_pad_row(chunk), ldw=_pad_row(ob) if transposed else ob)


@dataclasses.dataclass(frozen=True)
class PointwiseWgradBlocking:
    """Launch parameters of the pointwise wgrad.  A CTA owns one ``[Cib,
    Cob]`` block; its threads split into ``pgroups`` position groups of
    ``8 x 8`` register tiles each (one group at 128 x 128), which walk a
    contiguous share of the ``tiles`` position tiles (``positions`` of one
    image each, the last one of an image ragged), ``splits`` shares per
    block.  The groups' sums meet in shared memory in group order; the
    shares' in a ``[splits, |dw| + |db|]`` workspace."""
    positions: int
    pgroups: int
    tiles: int
    splits: int


PW_WGRAD_MAX_POSITIONS = 64


def pointwise_wgrad_smem_bytes(positions: int, cib: int, cob: int,
                               pgroups: int) -> int:
    """The staged x rows (rounded up to 16 bytes) and dz rows of one tile,
    or the position groups' partial ``[Cib, Cob]`` blocks and ``db`` rows
    when those are larger (they reuse the staging buffer)."""
    stage = -(-positions * cib // 4) * 4 + positions * cob
    return 4 * max(stage, pgroups * (cib * cob + cob))


@functools.lru_cache(maxsize=4096)
def choose_pointwise_wgrad_blocking(n: int, hw: int, ciblk: int, cib: int,
                                    coblk: int, cob: int,
                                    machine: MachineModel = H100_SXM
                                    ) -> PointwiseWgradBlocking:
    """Tile the pointwise weight gradient: ``PW_WGRAD_MAX_POSITIONS`` (or
    fewer, to fit the budget) positions a tile; splits as the dense
    wgrad's."""
    groups = -(-cib // machine.lanes) * -(-cob // machine.lanes)
    if groups > machine.threads:
        raise SmemMisfitError(
            f"cib={cib} x cob={cob} needs {groups} thread "
            f"groups; a CTA has {machine.threads} threads")
    pgroups = machine.threads // groups
    positions = min(hw, PW_WGRAD_MAX_POSITIONS)
    while pointwise_wgrad_smem_bytes(positions, cib, cob, pgroups) \
            > machine.smem_budget:
        if positions == 1:
            raise SmemMisfitError(f"no pointwise wgrad tile fits: "
                                  f"cib={cib}, cob={cob}")
        positions //= 2
    tiles = n * -(-hw // positions)
    return PointwiseWgradBlocking(
        positions=positions, pgroups=pgroups, tiles=tiles,
        splits=_splits(tiles, ciblk * coblk, machine))


# ---------------------------------------------------------------------------
# depthwise: the per-lane tap loop
# ---------------------------------------------------------------------------

# filter taps one depthwise thread holds in registers (5x5)
DW_MAX_TAPS = 25
# the most positions of a tile that one depthwise thread computes: bounds a
# tile at (threads // Cb) * DW_THREAD_POSITIONS positions
DW_THREAD_POSITIONS = 32


@dataclasses.dataclass(frozen=True)
class DepthwiseBlocking:
    """Launch parameters of the depthwise tap kernel: a ``hob x wob`` tile
    of the output (forward) or of the unpadded input gradient (dgrad) per
    CTA, over a staged ``hwin x wwin`` window of the input (forward) or of
    the cotangent (dgrad), the whole ``Cb`` pencil at once."""
    hob: int
    wob: int
    hwin: int
    wwin: int


def depthwise_smem_bytes(hwin: int, wwin: int, cb: int,
                         machine: MachineModel = H100_SXM,
                         gap: bool = False) -> int:
    """The staged f32 window; with ``gap`` at least the ``[position groups,
    Cb]`` partial sums."""
    stage = 4 * hwin * wwin * cb
    if gap:
        stage = max(stage, 4 * (machine.threads // cb) * cb)
    return stage


def _depthwise_groups(cb: int, machine: MachineModel) -> int:
    if cb > machine.threads:
        raise SmemMisfitError(
            f"pencil Cb={cb} wider than a CTA's "
            f"{machine.threads} threads")
    return machine.threads // cb


@functools.lru_cache(maxsize=4096)
def choose_depthwise_blocking(n: int, cblk: int, ho: int, wo: int, cb: int,
                              hf: int, wf: int, stride: int = 1,
                              dilation=(1, 1),
                              machine: MachineModel = H100_SXM,
                              dgrad: bool = False,
                              gap: bool = False) -> DepthwiseBlocking:
    """Tile the depthwise forward over its ``ho x wo`` output or, with
    ``dgrad``, the input gradient over the unpadded ``ho x wo`` input.

    A thread holds one lane and up to ``DW_THREAD_POSITIONS`` positions,
    so a tile has at most ``(threads // Cb) * DW_THREAD_POSITIONS``
    positions;
    its window must fit the shared-memory budget.  Tiles divide the grid.
    Among the tiles that give every thread a position, the largest whose
    grid ``n * cblk * tiles`` fills the card (``machine.wave``) is taken,
    ties to the smaller window; where none does, the one with the most
    CTAs."""
    groups = _depthwise_groups(cb, machine)
    cap = groups * DW_THREAD_POSITIONS
    hf_eff = (hf - 1) * dilation[0] + 1
    wf_eff = (wf - 1) * dilation[1] + 1

    def window(h: int, w: int) -> tuple[int, int]:
        if dgrad:
            return dgrad_window(h, w, hf_eff, wf_eff, stride)
        return halo_dims(h, w, hf, wf, stride, dilation)

    fits = []
    for h in divisors(ho):
        for w in divisors(wo):
            win = window(h, w)
            if h * w <= cap and depthwise_smem_bytes(
                    *win, cb, machine, gap) <= machine.smem_budget:
                fits.append((h, w, win))
    if not fits:
        raise SmemMisfitError(
            f"no depthwise tile fits: Cb={cb}, filter {hf}x{wf}, stride "
            f"{stride}, dilation {dilation} needs more than "
            f"{machine.smem_budget} bytes of shared memory even at 1x1")

    def grid(h: int, w: int) -> int:
        return n * cblk * (ho // h) * (wo // w)

    # tiles that give every thread a position, where the map has any
    busy = [f for f in fits if f[0] * f[1] >= groups] or fits
    full = [f for f in busy if grid(f[0], f[1]) >= machine.wave]
    if full:
        h, w, win = max(full, key=lambda f: (f[0] * f[1],
                                             -f[2][0] * f[2][1]))
    else:
        h, w, win = max(busy, key=lambda f: (grid(f[0], f[1]),
                                             -f[2][0] * f[2][1]))
    return DepthwiseBlocking(hob=h, wob=w, hwin=win[0], wwin=win[1])


@dataclasses.dataclass(frozen=True)
class DepthwiseWgradBlocking:
    """Launch parameters of the depthwise wgrad: a CTA holds one pencil's
    ``[Hf*Wf, Cb]`` tap sums, a lane and its taps per thread, and walks a
    contiguous share of the ``tiles`` position tiles (``hob x wob`` outputs
    of one image); ``splits`` shares per pencil block.  The position
    groups' sums meet in shared memory in group order; the shares' in a
    ``[splits, |dw| + |db|]`` workspace."""
    hob: int
    wob: int
    tiles: int
    splits: int


DW_WGRAD_MAX_POSITIONS = 256


def depthwise_wgrad_smem_bytes(hob: int, wob: int, cb: int, hf: int, wf: int,
                               stride: int, dilation=(1, 1),
                               machine: MachineModel = H100_SXM) -> int:
    """The halo'd f32 x window (rounded up to 16 bytes) and the cotangent
    tile, or the position groups' ``[Hf*Wf + 1, Cb]`` partial sums when
    those are larger (they reuse the staging buffer)."""
    hib, wib = halo_dims(hob, wob, hf, wf, stride, dilation)
    stage = -(-hib * wib * cb // 4) * 4 + hob * wob * cb
    red = _depthwise_groups(cb, machine) * (hf * wf + 1) * cb
    return 4 * max(stage, red)


@functools.lru_cache(maxsize=4096)
def choose_depthwise_wgrad_blocking(n: int, cblk: int, ho: int, wo: int,
                                    cb: int, hf: int, wf: int,
                                    stride: int = 1, dilation=(1, 1),
                                    machine: MachineModel = H100_SXM
                                    ) -> DepthwiseWgradBlocking:
    """Tile the depthwise weight gradient: the ``hob x wob`` (dividing ``Ho
    x Wo``) with the most positions, up to ``DW_WGRAD_MAX_POSITIONS``,
    that fits the budget, ties to the smaller window; splits as the dense
    wgrad's."""
    if hf * wf > DW_MAX_TAPS:
        raise ValueError(f"filter {hf}x{wf} has more than {DW_MAX_TAPS} taps")
    best = None
    for h in divisors(ho):
        for w in divisors(wo):
            if h * w > DW_WGRAD_MAX_POSITIONS:
                continue
            smem = depthwise_wgrad_smem_bytes(h, w, cb, hf, wf, stride,
                                              dilation, machine)
            if smem > machine.smem_budget:
                continue
            key = (h * w, -smem)
            if best is None or key > best[0]:
                best = (key, h, w)
    if best is None:
        raise SmemMisfitError(
            f"no depthwise wgrad tile fits: Cb={cb}, filter {hf}x{wf}, "
            f"stride {stride} needs more than {machine.smem_budget} bytes")
    _, h, w = best
    tiles = n * (ho // h) * (wo // w)
    return DepthwiseWgradBlocking(hob=h, wob=w, tiles=tiles,
                                  splits=_splits(tiles, cblk, machine))


# ---------------------------------------------------------------------------
# streamed (halo-ring) kernels: csrc/conv2d_stream.cu
# ---------------------------------------------------------------------------
#
# The streamed forward and dgrad keep the window kernels' register tile
# (``positions x lanes`` f32 sums a thread), so one CTA owns a *band* of at
# most ``tile_positions`` output positions, ``hob x wob``.  Per channel
# chunk the band's input rows reach shared memory as strips of ``hso``
# output rows through a circular row buffer of ``ring_rows`` rows, filled by
# ``cp.async``: the rows of strip k+1 are in flight while strip k's taps run,
# and the ``Hf - stride`` halo rows shared by two strips are copied from
# device memory once per chunk.  The ring holds the rows of two consecutive
# strips: those of a window of ``2 * hso`` output rows (or of the band, when
# it is one strip).  The weight chunk is staged once per chunk.
#
# The wgrad gives each CTA the window wgrad's tap group and walks a share of
# ``(image, column tile, strip)`` items; per item it rings a halo'd x strip
# (``hso`` output rows' input rows, ``wob`` columns) and a disjoint
# cotangent strip, each with its ``z`` when the activation needs the
# prologue.


def _round4(n: int) -> int:
    return -(-n // 4) * 4


# strip counts a streamed band is compiled for (csrc/conv2d_stream.cu
# kStrips): strip k of a band owns slots [k * 8 / n, (k + 1) * 8 / n) of a
# thread's register tile
STREAM_STRIPS = (1, 2)


def stream_ring_rows(hob: int, hso: int, hf: int, stride: int,
                     dgrad: bool = False) -> int:
    """Rows of the circular buffer: the input (forward) or cotangent
    (dgrad) rows that feed ``min(2 * hso, hob)`` output rows of the band."""
    rows = min(2 * hso, hob)
    if dgrad:
        return dgrad_window(rows, 1, hf, 1, stride)[0]
    return (rows - 1) * stride + hf


@dataclasses.dataclass(frozen=True)
class StreamBlocking:
    """Launch parameters of the streamed forward or dgrad: a ``hob x wob``
    band of the output (forward) or of the unpadded input gradient (dgrad)
    per CTA, streamed as ``n_strips`` strips of ``hso`` rows through a ring
    of ``ring_rows x ring_cols`` cells of ``chunk`` channels; the staged
    weight rows are ``ldw`` floats apart."""
    hob: int
    wob: int
    hso: int
    chunk: int
    ring_rows: int
    ring_cols: int
    ldw: int

    @property
    def n_strips(self) -> int:
        return self.hob // self.hso


def stream_gap_floats(cob: int, machine: MachineModel) -> int:
    """The forward's GAP partial sums, ``[position groups, Cob]`` f32."""
    return machine.threads // -(-cob // machine.lanes) * cob


def stream_smem_bytes(ring_rows: int, ring_cols: int, chunk: int, ldw: int,
                      hf: int, wf: int, dgrad: bool = False,
                      prologue: bool = False, gap_floats: int = 0) -> int:
    """Dynamic shared memory of one streamed CTA, in the kernel's layout:
    the weight chunk ``[Hf*Wf, chunk, ldw]``, the ring ``[ring_rows,
    ring_cols, chunk]`` (twice in the dgrad with the prologue: ``z`` is
    ringed beside the cotangent), each rounded up to 16 bytes, and in the
    dgrad one zero run of ``chunk`` floats for the taps the stride skips.
    The forward's GAP partial sums (``gap_floats``) reuse the buffer."""
    ring = _round4(ring_rows * ring_cols * chunk)
    floats = _round4(hf * wf * chunk * ldw) + ring
    if dgrad:
        floats += (ring if prologue else 0) + chunk
    return 4 * max(floats, gap_floats)


def _stream_band(n_oblk: int, oh: int, ow: int, lanes: int, pencil: int,
                 machine: MachineModel, hso: int | None, smem, what: str):
    """Pick a band ``(hob, wob, hso, chunk)`` of an ``oh x ow`` grid.

    Bands divide the grid and fit the register tile; a band is one or two
    strips (``STREAM_STRIPS``), so ``hso`` is ``hob`` or ``hob / 2`` (or
    pinned); ``chunk`` is the largest divisor of ``pencil`` whose ``smem(
    hob, wob, hso, chunk)`` fits the budget.  A band that fills less than
    half the register tile wastes the FMAs' operand reads (on the H100 a
    streamed forward at 2 of 8 slots a thread ran 4x slower than at 7), so
    bands at least half the tile come first, where the map has them; among
    those, the fullest whose grid ``n_oblk * bands`` fills the card
    (``machine.wave``), else the one with the most CTAs; ties to two strips
    (the ring then has a next strip to copy while one computes) and then
    to the wider band."""
    cap = tile_positions(lanes, machine)
    cands = []
    for h in divisors(oh):
        for strips in STREAM_STRIPS:
            s = h // strips
            if h % strips or (hso is not None and s != hso):
                continue
            for w in divisors(ow):
                if h * w > cap:
                    continue
                chunk = next((c for c in reversed(divisors(pencil))
                              if smem(h, w, s, c) <= machine.smem_budget),
                             None)
                if chunk is not None:
                    cands.append((h, w, s, chunk))
    if not cands:
        if hso is not None and oh % hso:
            raise ValueError(f"hso={hso} must divide the rows {oh}")
        raise SmemMisfitError(
            f"no streamed band fits the {what}: needs more than "
            f"{machine.smem_budget} bytes of shared memory or {cap} "
            "register-tile positions even at 1x1")

    def fill(c) -> int:
        return c[0] * c[1]

    def grid(c) -> int:
        return n_oblk * (oh // c[0]) * (ow // c[1])

    def ties(c):
        return c[0] // c[2], c[1]

    busy = [c for c in cands if 2 * fill(c) >= cap] or [
        c for c in cands if fill(c) == max(map(fill, cands))]
    full = [c for c in busy if grid(c) >= machine.wave]
    if full:
        return max(full, key=lambda c: (fill(c),) + ties(c))
    return max(busy, key=lambda c: (grid(c), fill(c)) + ties(c))


@functools.lru_cache(maxsize=4096)
def choose_stream_blocking(n: int, hi: int, wi: int, ci: int, co: int,
                           hf: int, wf: int, stride: int, cob: int, cib: int,
                           machine: MachineModel = H100_SXM,
                           gap: bool = False,
                           hso: int | None = None) -> StreamBlocking:
    """Tile the streamed forward of ``n`` images over a padded ``hi x wi``
    input (the kernel masks the pads), with the pencils ``cob``/``cib`` of
    the operands' layout; ``hso`` pins the strip height (it must divide the
    band).  Bands are sized to fill the card (``_stream_band``), unlike
    the reference's default of the whole map in one grid step: CTAs run in
    parallel here, and a whole-map band would give conv1_x of VGG-16 at
    batch 8 only 8 CTAs."""
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output for input {hi}x{wi}, filter {hf}x{wf}")
    if co % cob or ci % cib:
        raise ValueError(f"pencils cob={cob}/cib={cib} must divide "
                         f"co={co}/ci={ci}")
    if hso is not None and hso < 1:
        raise ValueError(f"hso={hso} must be >= 1")
    gap_floats = stream_gap_floats(cob, machine) if gap else 0

    def smem(h, w, s, c):
        return stream_smem_bytes(stream_ring_rows(h, s, hf, stride),
                                 halo_dims(h, w, hf, wf, stride)[1], c, cob,
                                 hf, wf, gap_floats=gap_floats)

    h, w, s, chunk = _stream_band(
        n * (co // cob), ho, wo, cob, cib, machine, hso, smem,
        f"streamed forward (filter {hf}x{wf}, stride {stride}, cob={cob})")
    return StreamBlocking(hob=h, wob=w, hso=s, chunk=chunk,
                          ring_rows=stream_ring_rows(h, s, hf, stride),
                          ring_cols=halo_dims(h, w, hf, wf, stride)[1],
                          ldw=cob)


@functools.lru_cache(maxsize=4096)
def choose_stream_dgrad_blocking(n: int, hi: int, wi: int, hf: int, wf: int,
                                 stride: int, ciblk: int, cib: int, cob: int,
                                 machine: MachineModel = H100_SXM,
                                 prologue: bool = False,
                                 hso: int | None = None) -> StreamBlocking:
    """Tile the streamed input gradient over the unpadded ``hi x wi``
    input: the forward's rules with the pencils' roles swapped (the
    register tile's lanes are Cib, the chunk divides Cob), a ring of
    cotangent rows in the cotangent's own coordinates (``dgrad_window``),
    with ``z`` ringed beside it when ``prologue``."""
    if hso is not None and hso < 1:
        raise ValueError(f"hso={hso} must be >= 1")
    ldw = _dgrad_ldw(cib)

    def smem(h, w, s, c):
        return stream_smem_bytes(
            stream_ring_rows(h, s, hf, stride, dgrad=True),
            dgrad_window(h, w, hf, wf, stride)[1], c, ldw, hf, wf,
            dgrad=True, prologue=prologue)

    h, w, s, chunk = _stream_band(
        n * ciblk, hi, wi, cib, cob, machine, hso, smem,
        f"streamed dgrad (filter {hf}x{wf}, stride {stride}, cib={cib})")
    return StreamBlocking(
        hob=h, wob=w, hso=s, chunk=chunk,
        ring_rows=stream_ring_rows(h, s, hf, stride, dgrad=True),
        ring_cols=dgrad_window(h, w, hf, wf, stride)[1], ldw=ldw)


@dataclasses.dataclass(frozen=True)
class StreamWgradBlocking:
    """Launch parameters of the streamed wgrad.  A CTA holds ``taps`` filter
    taps' ``[Cib, Cob]`` blocks in its register tile (``tap_groups`` CTAs
    cover the filter, as in the window wgrad) and walks a contiguous share
    of the ``items`` (image, column tile, strip) items, ``splits`` shares
    per (tap group, Ci block, Co block).  An item is ``hso`` output rows x
    ``wob`` columns; its x rows go through a ring of ``ring_rows`` rows of
    ``ring_cols`` columns, its cotangent rows through two slots."""
    hso: int
    wob: int
    taps: int
    tap_groups: int
    items: int
    splits: int
    ring_rows: int
    ring_cols: int


def stream_wgrad_smem_bytes(hso: int, wob: int, cib: int, cob: int, hf: int,
                            wf: int, stride: int,
                            prologue: bool = False) -> int:
    """The x ring ``[hin + hso * stride, wib, Cib]`` (rounded up to 16
    bytes) and two cotangent slots ``[hso * wob, Cob]`` (four with the
    prologue's ``z``)."""
    hin, wib = halo_dims(hso, wob, hf, wf, stride)
    ring = _round4((hin + hso * stride) * wib * cib)
    return 4 * (ring + (4 if prologue else 2) * hso * wob * cob)


@functools.lru_cache(maxsize=4096)
def choose_stream_wgrad_blocking(n: int, ho: int, wo: int, hf: int, wf: int,
                                 stride: int, ciblk: int, cib: int,
                                 coblk: int, cob: int,
                                 machine: MachineModel = H100_SXM,
                                 prologue: bool = False,
                                 hso: int | None = None
                                 ) -> StreamWgradBlocking:
    """Tile the streamed weight gradient: taps as the window wgrad's; the
    item ``hso x wob`` (dividing ``Ho x Wo``) with the most positions, up
    to ``WGRAD_MAX_POSITIONS``, that fits the budget, ties to two strips or
    more per column and then to less shared memory; splits as the window
    wgrad's.  ``hso`` pins the strip height."""
    lanes, threads = machine.lanes, machine.threads
    groups = -(-cib // lanes) * -(-cob // lanes)
    if groups > threads:
        raise SmemMisfitError(f"cib={cib} x cob={cob} needs {groups} thread "
                              f"groups; a CTA has {threads} threads")
    if hso is not None and (hso < 1 or ho % hso):
        raise ValueError(f"hso={hso} must divide Ho={ho}")
    taps = min(hf * wf, threads // groups)
    tap_groups = -(-hf * wf // taps)
    best = None
    for s in ([hso] if hso is not None else divisors(ho)):
        for w in divisors(wo):
            if s * w > WGRAD_MAX_POSITIONS:
                continue
            smem = stream_wgrad_smem_bytes(s, w, cib, cob, hf, wf, stride,
                                           prologue)
            if smem > machine.smem_budget:
                continue
            key = (s * w, ho // s >= 2, -smem)
            if best is None or key > best[0]:
                best = (key, s, w)
    if best is None:
        raise SmemMisfitError(
            f"no streamed wgrad strip fits: cib={cib}, cob={cob}, filter "
            f"{hf}x{wf}, stride {stride} needs more than "
            f"{machine.smem_budget} bytes of shared memory even at 1x1")
    _, s, w = best
    items = n * (wo // w) * (ho // s)
    hin, wib = halo_dims(s, w, hf, wf, stride)
    return StreamWgradBlocking(
        hso=s, wob=w, taps=taps, tap_groups=tap_groups, items=items,
        splits=_splits(items, tap_groups * ciblk * coblk, machine),
        ring_rows=hin + s * stride, ring_cols=wib)
