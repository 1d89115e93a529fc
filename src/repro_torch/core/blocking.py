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

The reference's rules are kept: ``hob``/``wob`` divide ``Ho``/``Wo`` (so a
tile never straddles the map's edge) and the tile shrinks rows first, then
columns.  Where the reference halves a dim until it fits, this model takes
the largest divisor that fits, which is never smaller.  ``MachineModel``'s
``threads``/``lanes``/``positions`` must equal the compiled kernels'
constants; the kernel wrappers check them against the built libraries.

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

from repro_torch.core.conv2d_common import halo_dims
from repro_torch.core.layout import divisors

__all__ = ["MachineModel", "H100_SXM", "Blocking", "tile_positions",
           "smem_bytes", "choose_blocking", "dgrad_extents", "dgrad_window",
           "DgradBlocking", "dgrad_smem_bytes", "choose_dgrad_blocking",
           "WgradBlocking", "wgrad_smem_bytes", "choose_wgrad_blocking"]


@dataclasses.dataclass(frozen=True)
class MachineModel:
    name: str
    threads: int          # threads per CTA (the kernel's kThreads)
    lanes: int            # output channels in one thread's register tile
    positions: int        # output positions in one thread's register tile
    smem_budget: int      # shared-memory bytes one CTA may stage
    sms: int = 132        # streaming multiprocessors
    ctas_per_sm: int = 2  # resident CTAs the kernels' launch bounds ask for


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
        raise ValueError(f"cob={cob} needs {groups} channel groups; a CTA has "
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
        raise ValueError(
            f"no tile fits the {what}: needs more than {budget} bytes of shared "
            f"memory or {cap} register-tile positions even at 1x1")
    return h, w, largest_fitting(pencil, lambda c: fits(h, w, c))


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
        raise ValueError(f"cib={cib} x cob={cob} needs {groups} thread "
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
        raise ValueError(
            f"no wgrad tile fits: cib={cib}, cob={cob}, filter {hf}x{wf}, "
            f"stride {stride} needs more than {machine.smem_budget} bytes of "
            "shared memory even at 1x1")
    _, h, w = best
    tiles = n * (ho // h) * (wo // w)
    base = tap_groups * ciblk * coblk
    target = 2 * machine.ctas_per_sm * machine.sms
    splits = max(1, min(tiles, -(-target // base)))
    return WgradBlocking(hob=h, wob=w, taps=taps, tap_groups=tap_groups,
                         tiles=tiles, splits=splits)
