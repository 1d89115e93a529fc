"""Memory-overhead accounting: the paper's zero-overhead claim, in bytes.

The port of ``repro/core/memory_model.py``.  For each convolution algorithm
it counts the *extra* bytes beyond the irreducible input, weights and
output:

  direct (ours)   0                                       (paper §4)
  im2col+GEMM     N * Ho*Wo * Hf*Wf*Ci * dtype            (the packed matrix)
  MEC (Cho&Brand) ~ im2col / 3.2 (reported average)        (paper §2.2)
  FFT             kernel padded to image + complex spectra (paper §2.1)

and the bytes the blocked layout and the fused epilogue save or trade:
pad-to-block lanes, the precision policy's split of a training working set,
the halo rows a tiled forward fetches twice, the repacks a chained layout
removes.  Pure Python on shapes; ``core.conv_baselines`` materializes the
im2col and FFT buffers these numbers describe.  Everything but
``bytes_halo_refetch`` is the reference's formula; that one reads the
port's forward tiles (``core.blocking.FwdBlocking``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.layout import choose_pencil
from repro_torch.core.padding import Padding, normalize_padding, out_size
from repro_torch.core.precision import resolve_precision

__all__ = ["ConvShape", "bytes_overhead", "bytes_channel_pad",
           "bytes_precision_split", "bytes_backward_transient",
           "bytes_halo_refetch", "overhead_table",
           "bytes_repack_boundary", "chain_repack_bytes",
           "bytes_epilogue_fusion"]


@dataclasses.dataclass(frozen=True)
class ConvShape:
    """One convolution layer's shape, with real padding semantics.

    ``pad`` accepts what :func:`normalize_padding` does (an int, "SAME" /
    "VALID", or explicit ``((lo, hi), (lo, hi))`` pairs), so ``ho``/``wo``
    are what the convs produce (TF-SAME's asymmetric split included)."""
    name: str
    n: int
    hi: int
    wi: int
    ci: int
    co: int
    hf: int
    wf: int
    stride: int = 1
    pad: Padding = 0
    groups: int = 1
    dilation: int | tuple = 1

    @property
    def dil(self) -> tuple:
        d = self.dilation
        return d if isinstance(d, tuple) else (d, d)

    @property
    def hf_eff(self) -> int:
        """Dilated filter extent: what padding and outputs resolve against."""
        return (self.hf - 1) * self.dil[0] + 1

    @property
    def wf_eff(self) -> int:
        return (self.wf - 1) * self.dil[1] + 1

    @property
    def cig(self) -> int:
        """Per-group input channels: the weight's input extent."""
        return self.ci // self.groups

    @property
    def pads(self):
        """Explicit per-edge pads ``((ph_lo, ph_hi), (pw_lo, pw_hi))``."""
        return normalize_padding(self.pad, self.hf_eff, self.wf_eff,
                                 self.stride, self.hi, self.wi)

    @property
    def padded_hi(self) -> int:
        (lo, hi), _ = self.pads
        return self.hi + lo + hi

    @property
    def padded_wi(self) -> int:
        _, (lo, hi) = self.pads
        return self.wi + lo + hi

    @property
    def ho(self) -> int:
        return out_size(self.padded_hi, self.hf_eff, self.stride)

    @property
    def wo(self) -> int:
        return out_size(self.padded_wi, self.wf_eff, self.stride)

    def flops(self) -> int:
        return (2 * self.n * self.ho * self.wo * self.co
                * self.hf * self.wf * self.cig)

    def base_bytes(self, dtype_bytes: int = 4) -> int:
        x = self.n * self.hi * self.wi * self.ci
        w = self.hf * self.wf * self.cig * self.co
        y = self.n * self.ho * self.wo * self.co
        return (x + w + y) * dtype_bytes


def bytes_overhead(s: ConvShape, algorithm: str, dtype_bytes: int = 4) -> int:
    """Extra working-set bytes beyond input + weights + output."""
    if algorithm == "direct":
        return 0
    if algorithm == "im2col":
        return s.n * s.ho * s.wo * s.hf * s.wf * s.ci * dtype_bytes
    if algorithm == "mec":
        # Cho & Brand 2017 report an average 3.2x reduction over im2col
        return int(bytes_overhead(s, "im2col", dtype_bytes) / 3.2)
    if algorithm == "fft":
        hi, wi = s.padded_hi, s.padded_wi
        # the kernel zero-padded to the image, and the rfft spectra of x and
        # w (complex: 2 words an element, width hi * (wi // 2 + 1))
        kpad = hi * wi * s.ci * s.co * dtype_bytes
        spec = 2 * dtype_bytes * hi * (wi // 2 + 1) * (s.n * s.ci + s.ci * s.co)
        return kpad + spec
    raise ValueError(f"unknown algorithm {algorithm!r}")


def bytes_channel_pad(s: ConvShape, lane: int = 128,
                      dtype_bytes: int = 4) -> int:
    """Extra bytes the pad-to-block layout trades for full lanes: each
    channel dim zero-padded up to a multiple of its pencil ``min(C,
    lane)`` (``choose_pencil(pad_to_block=True)``); 0 when the channels
    divide their pencils."""
    def padded(c: int) -> int:
        pencil = min(c, lane)
        return -(-c // pencil) * pencil

    ci_p, co_p = padded(s.ci), padded(s.co)
    x = s.n * s.hi * s.wi * (ci_p - s.ci)
    w = s.hf * s.wf * (ci_p * co_p - s.ci * s.co)
    y = s.n * s.ho * s.wo * (co_p - s.co)
    return (x + w + y) * dtype_bytes


def bytes_precision_split(s: ConvShape, precision="bf16",
                          master_bytes: int = 4) -> dict:
    """Training working-set bytes of one layer under a precision policy, by
    role: ``activations`` (x and y at the operand dtype), ``params_master``
    (the f32 weights), ``params_compute`` (the operand-cast copy of w a
    conv contracts, 0 when the operand is the master dtype),
    ``vjp_residual`` (the padded input and the pre-activation a training
    forward stores, at the residual dtype); ``f32_total`` is the same set
    with every role at ``master_bytes`` and ``saved`` the difference."""
    pol = resolve_precision(precision)
    ob, rb = pol.operand_itemsize, pol.residual_dtype.itemsize
    x = s.n * s.hi * s.wi * s.ci
    y = s.n * s.ho * s.wo * s.co
    w = s.hf * s.wf * s.cig * s.co
    xp = s.n * s.padded_hi * s.padded_wi * s.ci
    acts = (x + y) * ob
    master = w * master_bytes
    compute = 0 if ob == master_bytes else w * ob
    residual = (xp + y) * rb
    total = acts + master + compute + residual
    f32_total = (x + y + w + xp + y) * master_bytes
    return {
        "activations": acts, "params_master": master,
        "params_compute": compute, "vjp_residual": residual,
        "total": total, "f32_total": f32_total,
        "saved": f32_total - total,
    }


def bytes_backward_transient(s: ConvShape, precision="bf16") -> int:
    """Bytes a layer's backward holds only while it runs, past the working
    set ``bytes_precision_split`` counts: under a narrow policy the port's
    dz (``g * act'(z)`` formed once a layer by the dz pass, the size of the
    layer's output at the operand dtype, freed when its backward returns);
    0 at f32, whose backward kernels form dz as they stage ``g``.  A step
    holds the largest of its layers' at once."""
    pol = resolve_precision(precision)
    if pol.operand_itemsize == 4:
        return 0
    return s.n * s.ho * s.wo * s.co * pol.operand_itemsize


def _fetched(extent: int, out: int, tile: int, stride: int, f: int) -> int:
    """Input rows (or columns) the tiles of ``tile`` outputs fetch along one
    axis: each tile's halo window clipped to the ``extent`` the outputs
    touch (rows past it are zero fills the forward tile never reads)."""
    total = 0
    for t0 in range(0, out, tile):
        lo = t0 * stride
        total += min(lo + (tile - 1) * stride + f, extent) - lo
    return total


def bytes_halo_refetch(s: ConvShape, blk, dtype_bytes: int = 4) -> int:
    """Extra input bytes the dense forward tile fetches through its halos.

    Each CTA stages the halo'd window of its ``th x tw`` output tile,
    ``(th - 1) * stride + Hf`` rows by ``(tw - 1) * stride + Wf`` columns;
    neighbouring tiles overlap by ``Hf - stride`` rows or columns, so over
    the grid the touched extent ``E = (out - 1) * stride + filter`` is
    fetched more than once.  This returns that excess, summed over the
    images and the CTAs each output block's lanes split into:

        n * ceil(Co / cob) * nsplit * Ci * (fetched - Eh * Ew) * dtype_bytes

    ``blk`` is the port's ``core.blocking.FwdBlocking``; it reads ``th``,
    ``tw`` and ``nsplit`` (the window and the streamed tiles alike: a
    streamed band stages each of its rows once).  ``cob`` is the output
    pencil the port's layers take (``layout.choose_pencil(Co, 128)``).  A
    tile past the map's edge is clipped to it.  Zero when one tile covers
    the map: the zero-overhead ideal."""
    st = s.stride
    eh, ew = (s.ho - 1) * st + s.hf_eff, (s.wo - 1) * st + s.wf_eff
    fetched = (_fetched(eh, s.ho, blk.th, st, s.hf_eff)
               * _fetched(ew, s.wo, blk.tw, st, s.wf_eff))
    passes = s.n * -(-s.co // choose_pencil(s.co, 128)) * blk.nsplit
    return passes * (fetched - eh * ew) * s.ci * dtype_bytes


def bytes_repack_boundary(prev: ConvShape, nxt: ConvShape,
                          dtype_bytes: int = 4) -> int:
    """Pack/unpack bytes a chained blocked layout removes at one layer
    boundary: the NHWC path unpacks the producer's output and repacks the
    consumer's input, two activation copies that do not exist when layers
    stay in ``[N, C/Cb, H, W, Cb]`` (paper §4)."""
    unpack = prev.n * prev.ho * prev.wo * prev.co
    pack = nxt.n * nxt.hi * nxt.wi * nxt.ci
    return (unpack + pack) * dtype_bytes


def chain_repack_bytes(shapes, dtype_bytes: int = 4) -> int:
    """The removed pack/unpack bytes over a chain's interior boundaries."""
    return sum(bytes_repack_boundary(a, b, dtype_bytes)
               for a, b in zip(shapes, shapes[1:]))


def bytes_epilogue_fusion(s: ConvShape, dtype_bytes: int = 4, *,
                          residual: bool = False, gap: bool = False,
                          act_bwd: bool = False) -> int:
    """Device-memory bytes the fused epilogue and prologue remove for one
    layer, each a multiple of the output map ``m = N*Ho*Wo*Co*dtype``:
    ``residual`` (the unfused add writes and re-reads y: 2m), ``gap``
    (the map written and re-read to pool: 2m), ``act_bwd`` (``dz = g *
    act'(z)`` written and read once more: 2m).  The flags add up; 0 when
    nothing is fused."""
    m = s.n * s.ho * s.wo * s.co * dtype_bytes
    saved = 0
    if residual:
        saved += 2 * m
    if gap:
        saved += 2 * m
    if act_bwd:
        saved += 2 * m
    return saved


def overhead_table(shapes, dtype_bytes: int = 4, lane: int = 128):
    """One row a layer: its base MiB and each algorithm's overhead."""
    rows = []
    for s in shapes:
        base = s.base_bytes(dtype_bytes)
        rows.append({
            "layer": s.name,
            "base_MiB": base / 2**20,
            "direct_MiB": 0.0,
            "pad_MiB": bytes_channel_pad(s, lane, dtype_bytes) / 2**20,
            "im2col_MiB": bytes_overhead(s, "im2col", dtype_bytes) / 2**20,
            "mec_MiB": bytes_overhead(s, "mec", dtype_bytes) / 2**20,
            "fft_MiB": bytes_overhead(s, "fft", dtype_bytes) / 2**20,
            "im2col_vs_base": bytes_overhead(s, "im2col", dtype_bytes) / base,
        })
    return rows
