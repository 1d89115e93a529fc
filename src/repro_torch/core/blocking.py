"""Analytical blocking model of the forward kernel, fitted to one Hopper CTA.

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
``threads``/``lanes``/``positions`` must equal the compiled kernel's
constants; the kernel wrapper checks them against the built library.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.conv2d_common import halo_dims
from repro_torch.core.layout import divisors

__all__ = ["MachineModel", "H100_SXM", "Blocking", "tile_positions",
           "smem_bytes", "choose_blocking"]


@dataclasses.dataclass(frozen=True)
class MachineModel:
    name: str
    threads: int          # threads per CTA (the kernel's kThreads)
    lanes: int            # output channels in one thread's register tile
    positions: int        # output positions in one thread's register tile
    smem_budget: int      # shared-memory bytes one CTA may stage


H100_SXM = MachineModel(
    name="h100_sxm", threads=256, lanes=8, positions=8,
    smem_budget=96 * 1024)


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
    cap = tile_positions(cob, machine)

    def fits(h: int, w: int, chunk: int = 1) -> bool:
        return (h * w <= cap
                and smem_bytes(h, w, chunk, cob, hf, wf, stride, machine,
                               gap) <= machine.smem_budget)

    def largest_fitting(extent: int, fit) -> int | None:
        return next((d for d in reversed(divisors(extent)) if fit(d)), None)

    h, w = largest_fitting(ho, lambda d: fits(d, wo)), wo
    if h is None:                       # one row still too wide: tile columns
        h, w = 1, largest_fitting(wo, lambda d: fits(1, d))
    if w is None:
        raise ValueError(
            f"no tile fits: filter {hf}x{wf}, stride {stride}, cob={cob} "
            f"needs more than {machine.smem_budget} bytes of shared memory "
            f"or {cap} register-tile positions even at hob=1, wob=1")
    chunk = largest_fitting(cib, lambda c: fits(h, w, c))
    return Blocking(cob=cob, cib=cib, hob=h, wob=w, chunk=chunk)
