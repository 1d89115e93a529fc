"""The paper's blocked layouts (§4) as torch tensor permutations.

Feature maps are ``[N, C/Cb, H, W, Cb]`` — H×W matrices of channel
"pencils" of length ``Cb`` — and weights ``[Co/Cob, Ci/Cib, Hf, Wf, Cib,
Cob]``.  Both hold exactly the elements of the unblocked tensors: zero
memory overhead.  Pencils are chosen as the reference chooses them (target
128 lanes), so a blocked tensor of the port compares element for element
with the JAX package's.  On the GPU ``Cob`` is the fastest dimension of
every output store, so neighbouring threads write neighbouring addresses.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "BlockedConvLayout", "nhwc_to_blocked", "blocked_to_nhwc",
    "hwio_to_blocked", "blocked_to_hwio", "largest_divisor_leq", "divisors",
    "choose_pencil", "bld_to_blocked", "blocked_to_bld", "kd_to_blocked",
    "blocked_shapes", "assert_zero_overhead",
]


def divisors(n: int) -> list[int]:
    """All divisors of ``n``, ascending, from the prime factorization."""
    if n <= 0:
        raise ValueError(f"need positive dim, got {n}")
    factors: dict[int, int] = {}
    m, p = n, 2
    while p * p <= m:
        while m % p == 0:
            factors[p] = factors.get(p, 0) + 1
            m //= p
        p += 1 if p == 2 else 2
    if m > 1:
        factors[m] = factors.get(m, 0) + 1
    divs = [1]
    for prime, mult in factors.items():
        divs = [d * prime ** e for d in divs for e in range(mult + 1)]
    return sorted(divs)


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is ``<= cap`` (>=1)."""
    if n <= 0:
        raise ValueError(f"need positive dim, got {n}")
    if cap >= n:
        return n
    best = 1
    for d in divisors(n):
        if d > cap:
            break
        best = d
    return best


def choose_pencil(n: int, cap: int, *, min_util: float = 0.25,
                  pad_to_block: bool = False, groups: int = 1) -> int:
    """Largest divisor of ``n`` that is ``<= cap``; warns when it fills less
    than ``min_util`` of the achievable width (e.g. a prime channel count).
    ``pad_to_block=True`` returns the achievable width ``min(n, cap)``
    instead: the caller zero-pads the channels up to a multiple of it
    (``nhwc_to_blocked``/``hwio_to_blocked`` with ``pad_to_block=True``),
    trading the zero-overhead layout for full lanes, which is why it is
    never the default.

    ``groups > 1`` makes both the divisor and the check per group: the
    pencil divides ``n // groups``, so no pencil straddles a group of the
    block-diagonal weight, and the achievable width is ``min(n // groups,
    cap)``."""
    if groups > 1:
        if n % groups:
            raise ValueError(f"groups={groups} must divide C={n}")
        n //= groups
    target = min(n, cap)
    if pad_to_block:
        return target
    d = largest_divisor_leq(n, cap)
    if d < min_util * target:
        warnings.warn(
            f"channel pencil {d} for C={n} (cap {cap}) fills {d}/{target} "
            f"lanes; pass pad_to_block=True and zero-pad C to a multiple of "
            f"{target} to restore utilization", UserWarning, stacklevel=2)
    return d


@dataclasses.dataclass(frozen=True)
class BlockedConvLayout:
    """Channel pencils of one conv layer (the paper's ``C_i,b`` /
    ``C_o,b``).  Narrow layers take smaller divisors: VGG-16's first conv
    has ``Cib = 3``.  ``cb_w`` is the weight's input pencil when it differs
    from ``cb_in``: a depthwise weight has input extent ``Cig = 1``, so it
    is ``[C/Cb, 1, Hf, Wf, 1, Cb]`` while the maps keep the full pencil."""

    cb_in: int
    cb_out: int
    cb_w: int | None = None

    @property
    def cb_weight(self) -> int:
        return self.cb_in if self.cb_w is None else self.cb_w

    @staticmethod
    def choose(ci: int, co: int, lane: int = 128, min_util: float = 0.25,
               groups: int = 1) -> "BlockedConvLayout":
        """Pencils for a (possibly grouped) conv: per group for a grouped
        conv; for a depthwise conv (``groups == ci == co``) every lane is
        its own group, so the maps keep the full-channel pencil and only
        the weight's input pencil collapses to 1."""
        if groups > 1 and groups == ci == co:        # depthwise
            cb = choose_pencil(ci, lane, min_util=min_util)
            return BlockedConvLayout(cb_in=cb, cb_out=cb, cb_w=1)
        return BlockedConvLayout(
            cb_in=choose_pencil(ci, lane, min_util=min_util, groups=groups),
            cb_out=choose_pencil(co, lane, min_util=min_util, groups=groups))


def nhwc_to_blocked(x: torch.Tensor, cb: int, *,
                    pad_to_block: bool = False) -> torch.Tensor:
    """``[N, H, W, C] -> [N, C/Cb, H, W, Cb]`` (contiguous).

    ``pad_to_block=True`` zero-pads C up to the next multiple of ``cb``
    first (the escape hatch ``choose_pencil`` names for degenerate
    pencils); ``memory_model.bytes_channel_pad`` accounts the traded bytes
    and ``blocked_to_nhwc(..., c=C)`` strips them."""
    n, h, w, c = x.shape
    if c % cb:
        if not pad_to_block:
            raise ValueError(f"C={c} not divisible by block {cb} "
                             "(pass pad_to_block=True to zero-pad)")
        x = F.pad(x, (0, -c % cb))
        c = x.shape[-1]
    return x.reshape(n, h, w, c // cb, cb).permute(0, 3, 1, 2, 4).contiguous()


def blocked_to_nhwc(x: torch.Tensor, c: int | None = None) -> torch.Tensor:
    """Inverse of :func:`nhwc_to_blocked`; ``c`` strips a pad-to-block
    tail."""
    n, cblk, h, w, cb = x.shape
    out = x.permute(0, 2, 3, 1, 4).reshape(n, h, w, cblk * cb)
    if c is not None:
        if not 0 < c <= cblk * cb:
            raise ValueError(f"cannot strip to C={c} from {cblk * cb} packed "
                             "channels")
        out = out[..., :c]
    return out


def hwio_to_blocked(w: torch.Tensor, cib: int, cob: int, *,
                    pad_to_block: bool = False) -> torch.Tensor:
    """``[Hf, Wf, Ci, Co] -> [Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob]``;
    ``pad_to_block=True`` zero-pads Ci and Co up to block multiples (zero
    input channels add nothing, padded output channels are stripped)."""
    hf, wf, ci, co = w.shape
    if ci % cib or co % cob:
        if not pad_to_block:
            raise ValueError(
                f"Ci={ci}/Co={co} not divisible by blocks {cib}/{cob} "
                "(pass pad_to_block=True to zero-pad)")
        w = F.pad(w, (0, -co % cob, 0, -ci % cib))
        hf, wf, ci, co = w.shape
    w = w.reshape(hf, wf, ci // cib, cib, co // cob, cob)
    return w.permute(4, 2, 0, 1, 3, 5).contiguous()


def blocked_to_hwio(w: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hwio_to_blocked`."""
    coblk, ciblk, hf, wf, cib, cob = w.shape
    w = w.permute(2, 3, 1, 4, 0, 5)
    return w.reshape(hf, wf, ciblk * cib, coblk * cob)


# ---------------------------------------------------------------------------
# 1-D sequences (the Mamba conv):  [B, L, D]  <->  [B, D/Db, L, Db]
# ---------------------------------------------------------------------------

def bld_to_blocked(x: torch.Tensor, db: int) -> torch.Tensor:
    """``[B, L, D] -> [B, D/Db, L, Db]``, a view (no copy)."""
    b, l, d = x.shape
    if d % db:
        raise ValueError(f"D={d} not divisible by block {db}")
    return x.reshape(b, l, d // db, db).permute(0, 2, 1, 3)


def blocked_to_bld(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bld_to_blocked`."""
    b, dblk, l, db = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, l, dblk * db)


def kd_to_blocked(w: torch.Tensor, db: int) -> torch.Tensor:
    """Depthwise taps ``[K, D] -> [K, D/Db, Db]``."""
    k, d = w.shape
    if d % db:
        raise ValueError(f"D={d} not divisible by block {db}")
    return w.reshape(k, d // db, db)


def blocked_shapes(n: int, h: int, w: int, c: int, cb: int
                   ) -> Tuple[int, ...]:
    """The blocked shape of an ``[N, H, W, C]`` map at pencil ``cb``."""
    return (n, c // cb, h, w, cb)


def assert_zero_overhead(orig_shape, blocked_shape) -> None:
    """The paper's headline invariant: blocking never changes the element
    count."""
    if math.prod(orig_shape) != math.prod(blocked_shape):
        raise AssertionError(
            f"layout changed element count: {tuple(orig_shape)} -> "
            f"{tuple(blocked_shape)}")
