"""Elementwise agreement of two bf16 results, counted in bf16 ulps.

A kernel and its plain version that round at the same points differ only
where an f32 sum, taken in another order, lands on the other side of a
bf16 rounding boundary; such a difference is an ulp or two of the larger
value, and it is rare.  `agreement` measures both: the distance of each
element in ulps of max(|ref|, |out|), and the share of elements that
differ at all.  A `floor` counts ulps of at least that magnitude, for
outputs such as logits, whose values near 0 carry the absolute rounding
error of the sums before them.
"""

from __future__ import annotations

import torch

__all__ = ["ulps", "agreement"]

# bf16 keeps 8 significant bits: in [2^e, 2^(e+1)) its step is 2^(e-7)
_BF16_BITS = 8


def ulps(ref: torch.Tensor, out: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """|ref - out| in bf16 ulps of max(|ref|, |out|, floor), elementwise
    (f32)."""
    a, b = ref.float(), out.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(floor)
    _, exp = torch.frexp(mag)  # mag = m * 2^exp with m in [0.5, 1)
    step = torch.ldexp(torch.ones_like(mag), exp - _BF16_BITS)
    return (a - b).abs() / step


def agreement(ref: torch.Tensor, out: torch.Tensor, *, max_ulps: float,
              max_share_over: float, max_share_differ: float, floor: float = 0.0) -> dict:
    """How far `out` is from `ref`, and whether that is within the limits:
    at most a share `max_share_over` of the elements more than `max_ulps`
    ulps (of at least `floor`) apart, and at most a share
    `max_share_differ` differing at all.  Both tensors must be finite and
    of one shape."""
    if ref.shape != out.shape:
        raise ValueError(f"shapes differ: {tuple(ref.shape)} and {tuple(out.shape)}")
    a, b = ref.float(), out.float()
    u = ulps(a, b, floor)
    stats = {
        "max_abs_err": float((a - b).abs().max()),
        "max_ulps": float(u.max()),
        "share_over": float((u > max_ulps).float().mean()),
        "share_differ": float((a != b).float().mean()),
        "median_abs_ref": float(a.abs().median()),
        "max_abs_ref": float(a.abs().max()),
        "limits": {"max_ulps": max_ulps, "max_share_over": max_share_over,
                   "max_share_differ": max_share_differ, "floor": floor},
    }
    stats["ok"] = bool(
        torch.isfinite(b).all()
        and stats["share_over"] <= max_share_over
        and stats["share_differ"] <= max_share_differ
    )
    return stats
