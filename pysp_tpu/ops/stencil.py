"""Stencil primitives: padding, small convolutions, blurs, medians — pure XLA.

These replace the reference's cv2 calls (filter2D / GaussianBlur / blur / medianBlur /
copyMakeBorder; see SURVEY.md §2.9 item 4) with jittable equivalents that XLA fuses into
the surrounding develop program. Border semantics match OpenCV:

- ``pad_reflect`` == cv2.BORDER_REFLECT   (edge repeated;  np.pad 'symmetric')
- ``pad_reflect101`` == cv2.BORDER_REFLECT_101 (edge not repeated; np.pad 'reflect') —
  the default border for cv2 filtering ops
- ``pad_replicate`` == cv2.BORDER_REPLICATE

``filter2d`` is cross-correlation with the anchor at the kernel center, exactly like
cv2.filter2D (and like lax.conv_general_dilated, which does not flip kernels).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


def pad_reflect(x: Array, pad: int | Sequence[int]) -> Array:
    """cv2.BORDER_REFLECT on the last two axes."""
    t, b, l, r = _expand_pad(pad)
    cfg = [(0, 0)] * (x.ndim - 2) + [(t, b), (l, r)]
    return jnp.pad(x, cfg, mode="symmetric")


def pad_reflect101(x: Array, pad: int | Sequence[int]) -> Array:
    """cv2.BORDER_REFLECT_101 on the last two axes."""
    t, b, l, r = _expand_pad(pad)
    cfg = [(0, 0)] * (x.ndim - 2) + [(t, b), (l, r)]
    return jnp.pad(x, cfg, mode="reflect")


def pad_replicate(x: Array, pad: int | Sequence[int]) -> Array:
    """cv2.BORDER_REPLICATE on the last two axes."""
    t, b, l, r = _expand_pad(pad)
    cfg = [(0, 0)] * (x.ndim - 2) + [(t, b), (l, r)]
    return jnp.pad(x, cfg, mode="edge")


def _expand_pad(pad: int | Sequence[int]) -> tuple[int, int, int, int]:
    if isinstance(pad, int):
        return pad, pad, pad, pad
    pad = tuple(pad)
    if len(pad) == 2:
        return pad[0], pad[0], pad[1], pad[1]
    assert len(pad) == 4, "pad must be int, (py,px) or (top,bottom,left,right)"
    return pad  # type: ignore[return-value]


def _conv_valid(x: Array, kernel: Array) -> Array:
    """VALID cross-correlation on the last two axes; leading axes are batched.

    Implemented as shift-and-add rather than lax.conv: a single-channel 2D
    convolution is a separate (possibly reduced-precision) convolution kernel,
    while k*k shifted multiply-adds are elementwise work that fuses with
    neighbors, keeps exact f32 accumulation, and skips zero taps (the photosite
    phase kernels are half zeros).
    """
    kh, kw = kernel.shape
    h = x.shape[-2] - kh + 1
    w = x.shape[-1] - kw + 1
    k_host = np.asarray(kernel, np.float64)

    out = None
    for dy in range(kh):
        for dx in range(kw):
            coeff = float(k_host[dy, dx])
            if coeff == 0.0:
                continue
            # NOTE: always emit the multiply, even for coeff 1.0 — a
            # "skip mul-by-1" fast path changes the graph XLA fuses for the
            # EAG phase kernels, for no arithmetic gain. x*1.0 == x exactly.
            term = x[..., dy : dy + h, dx : dx + w] * jnp.asarray(coeff, x.dtype)
            out = term if out is None else out + term
    if out is None:
        return jnp.zeros(x.shape[:-2] + (h, w), x.dtype)
    return out


def filter2d(x: Array, kernel: Array, border: str = "reflect101") -> Array:
    """cv2.filter2D equivalent: same-size cross-correlation, center anchor.

    ``x`` is (..., H, W); an (H, W, C) image should be moved to (C, H, W) first (use
    ``filter2d_hwc`` for convenience).
    """
    kh, kw = kernel.shape
    pt, pb = kh // 2, (kh - 1) // 2
    pl, pr = kw // 2, (kw - 1) // 2
    pad_fn = {"reflect101": pad_reflect101, "reflect": pad_reflect, "replicate": pad_replicate}[border]
    return _conv_valid(pad_fn(x, (pt, pb, pl, pr)), kernel)


def filter2d_hwc(x: Array, kernel: Array, border: str = "reflect101") -> Array:
    """filter2d for channel-last images (H, W, C) or single-channel (H, W)."""
    if x.ndim == 2:
        return filter2d(x, kernel, border)
    return jnp.moveaxis(filter2d(jnp.moveaxis(x, -1, 0), kernel, border), 0, -1)


def box_blur3(x: Array) -> Array:
    """cv2.blur(src, (3,3)) equivalent (normalized box, reflect101 border)."""
    return filter2d(x, np.full((3, 3), 1.0 / 9.0, np.float32))


def box_sum3(x: Array) -> Array:
    """Unnormalized 3x3 box sum (reflect101 border) — box_blur3 without the 1/9.

    For the AHD H/V decision the blurred integer homogeneity counts are only
    compared, and the normalization is monotone: comparing raw sums (exact
    integers in f32, <= 81) gives a decision with NO rounding at all, removing
    the last-ulp tie-flip divergence class between compilations entirely.

    Implemented as explicit adds (not filter2d with a ones kernel) so the
    mul-free form stays out of _conv_valid, whose fusion pattern other callers
    depend on."""
    xp = pad_reflect101(x, 1)
    h, w = x.shape[-2], x.shape[-1]
    out = None
    for dy in range(3):
        for dx in range(3):
            term = xp[..., dy : dy + h, dx : dx + w]
            out = term if out is None else out + term
    return out


# cv2.getGaussianKernel(3, 1.0): exp(-x^2/2) at {-1,0,1}, normalized.
_G3 = np.exp(-0.5 * np.array([1.0, 0.0, 1.0]))
_G3 = _G3 / _G3.sum()
GAUSSIAN3_SIGMA1 = np.outer(_G3, _G3).astype(np.float32)


def gaussian_blur3(x: Array) -> Array:
    """cv2.GaussianBlur(src, (3,3), 1.0) equivalent (reflect101 border)."""
    return filter2d(x, GAUSSIAN3_SIGMA1)


def _window_stack(x: Array, k: int, pad_fn) -> Array:
    """Stack the k*k shifted neighborhoods of each pixel: (..., H, W) -> (k*k, ..., H, W)."""
    p = k // 2
    xp = pad_fn(x, p)
    h, w = x.shape[-2], x.shape[-1]
    views = [
        xp[..., dy : dy + h, dx : dx + w]
        for dy in range(k)
        for dx in range(k)
    ]
    return jnp.stack(views, axis=0)


def _batcher_comparators(n: int):
    """Comparator list (i, j), i<j, of Batcher's odd-even mergesort for size n
    (n rounded up to a power of two; extra wires are +inf)."""
    p = 1
    while p < n:
        p *= 2
    comparators = []

    def add(i, j):
        comparators.append((i, j))

    def oddeven_merge(lo, m, r):
        step = r * 2
        if step < m:
            oddeven_merge(lo, m, step)
            oddeven_merge(lo + r, m, step)
            for i in range(lo + r, lo + m - r, step):
                add(i, i + r)
        else:
            add(lo, lo + r)

    def oddeven_merge_sort_range(lo, hi):
        if hi - lo >= 1:
            mid = lo + (hi - lo) // 2
            oddeven_merge_sort_range(lo, mid)
            oddeven_merge_sort_range(mid + 1, hi)
            oddeven_merge(lo, hi - lo + 1, 1)

    oddeven_merge_sort_range(0, p - 1)
    return comparators, p


@lru_cache(maxsize=None)
def _median_network(n: int):
    """Pruned compare-exchange network computing element ``n // 2`` of n sorted values.

    Built from Batcher odd-even mergesort on the next power of two (pad wires are
    +inf), then constant-propagated and backward-pruned to only the comparators that
    can influence the median output wire.
    """
    comparators, p = _batcher_comparators(n)
    target = n // 2

    # Forward constant propagation: wire state True = finite value, False = +inf.
    # min(v, inf) = v and max(v, inf) = inf, so comparators touching an inf wire
    # degrade to (pass-through, const) moves.
    finite = [i < n for i in range(p)]
    ops = []  # (kind, i, j): kind 'cmp' = compare-exchange, 'mov' = j <- i
    for (i, j) in comparators:
        if finite[i] and finite[j]:
            ops.append(("cmp", i, j))
        elif finite[i] and not finite[j]:
            # min -> wire i keeps value; max -> inf stays at j: nothing moves
            pass
        elif not finite[i] and finite[j]:
            # min(inf, v) = v -> goes to wire i; max -> inf to wire j
            ops.append(("mov", i, j))  # ('mov', dst, src)
            finite[i], finite[j] = True, False

    # Backward pruning: track which wires can still influence the target output.
    # Comparators whose min- or max-side output is dead downstream degrade to a
    # single jnp.minimum / jnp.maximum (halves the ops for those wires).
    needed = {target}
    kept = []
    for kind, i, j in reversed(ops):
        if kind == "cmp":
            need_min = i in needed
            need_max = j in needed
            if not (need_min or need_max):
                continue
            if need_min and need_max:
                kept.append(("cmp", i, j))
            elif need_min:
                kept.append(("min", i, j))
            else:
                kept.append(("max", i, j))
            needed.add(i)
            needed.add(j)
        else:  # mov: wires[i] <- wires[j]
            if i in needed:
                kept.append((kind, i, j))
                needed.discard(i)
                needed.add(j)
    kept.reverse()
    return kept, target, p


def _median_of(values: list) -> Array:
    """Exact median of an odd-length list of equal-shape arrays via a pruned
    compare-exchange network — pure min/max graphs that XLA fuses into one kernel
    (a 25-way jnp.sort materializes ~13 full copies of the stacked array and
    dominated AHD postprocess time/memory)."""
    n = len(values)
    ops, target, p = _median_network(n)
    wires = list(values) + [None] * (p - n)  # pad wires only ever receive moves
    for kind, i, j in ops:
        if kind == "cmp":
            a, b = wires[i], wires[j]
            wires[i] = jnp.minimum(a, b)
            wires[j] = jnp.maximum(a, b)
        elif kind == "min":
            wires[i] = jnp.minimum(wires[i], wires[j])
        elif kind == "max":
            wires[j] = jnp.maximum(wires[i], wires[j])
        else:
            wires[i] = wires[j]
    return wires[target]


def _window_views(x: Array, k: int, pad_fn) -> list:
    p = k // 2
    xp = pad_fn(x, p)
    h, w = x.shape[-2], x.shape[-1]
    return [
        xp[..., dy : dy + h, dx : dx + w]
        for dy in range(k)
        for dx in range(k)
    ]


# --- Shared-column 5x5 median -------------------------------------------------
#
# A direct pruned network needs 202 min/max ops per 25-element median. The sliding
# window shares structure: sort each 5-column once (the sorted-column field is reused
# by the 5 windows it intersects), merge adjacent sorted-column pairs (10-sorted,
# reused by 3 windows), merge pairs-of-pairs (20-sorted, pruned to ranks 7..12), and
# finish with the classical two-sorted-list selection identity
#
#     rank_k(A ∪ B) = max_i( min(A[i], B[k-i]) )  (+ edge terms)
#
# which for k=12, |A|=20, |B|=5 is max(A7, min(A8,B4), ..., min(A12,B0)) — 10 ops.
# Amortized cost: 18 (column sort) + 22 (pair merge) + 36 (pruned 20-merge) + 10
# = 86 min/max ops per pixel, 2.35x fewer. Medians are selections (no arithmetic),
# so any correct network returns bit-identical values.

_SORT5_CE = ((0, 1), (3, 4), (2, 4), (2, 3), (0, 3), (0, 2), (1, 4), (1, 3), (1, 2))


def sort5(vals: list) -> list:
    """Elementwise 5-way sort of equal-shape arrays (optimal 9-comparator network)."""
    vals = list(vals)
    assert len(vals) == 5
    for i, j in _SORT5_CE:
        lo = jnp.minimum(vals[i], vals[j])
        hi = jnp.maximum(vals[i], vals[j])
        vals[i], vals[j] = lo, hi
    return vals


def _oddeven_merge_wires(a: tuple, b: tuple, out: list) -> tuple:
    """Batcher odd-even merge of sorted wire runs (arbitrary lengths); appends
    compare-exchange pairs to ``out`` and returns wires in sorted order."""
    if not a:
        return b
    if not b:
        return a
    if len(a) == 1 and len(b) == 1:
        out.append((a[0], b[0]))
        return (a[0], b[0])
    e = _oddeven_merge_wires(a[0::2], b[0::2], out)
    o = _oddeven_merge_wires(a[1::2], b[1::2], out)
    res = [e[0]]
    oi, ei = 0, 1
    while oi < len(o) and ei < len(e):
        out.append((o[oi], e[ei]))
        res.append(o[oi])
        res.append(e[ei])
        oi += 1
        ei += 1
    res.extend(o[oi:])
    res.extend(e[ei:])
    return tuple(res)


@lru_cache(maxsize=None)
def _merge_net(m: int, n: int, ranks: frozenset | None = None):
    """Typed-op merge network for sorted runs [0..m) + [m..m+n), backward-pruned to
    the given output ranks (all ranks if None). Returns (ops, order)."""
    ce: list = []
    order = _oddeven_merge_wires(tuple(range(m)), tuple(range(m, m + n)), ce)
    if ranks is None:
        return tuple(("cmp", i, j) for i, j in ce), order
    needed = {order[r] for r in ranks}
    kept = []
    for (i, j) in reversed(ce):
        nm, nM = i in needed, j in needed
        if not (nm or nM):
            continue
        kept.append(("cmp" if (nm and nM) else ("min" if nm else "max"), i, j))
        needed.add(i)
        needed.add(j)
    kept.reverse()
    return tuple(kept), order


def merge_sorted(a: list, b: list, ranks=None):
    """Elementwise merge of two sorted lists of arrays. Returns the m+n sorted
    fields, or a {rank: field} dict restricted to ``ranks`` (cheaper: the network
    is backward-pruned to those outputs)."""
    rk = frozenset(ranks) if ranks is not None else None
    ops, order = _merge_net(len(a), len(b), rk)
    wires = list(a) + list(b)
    for kind, i, j in ops:
        if kind == "cmp":
            lo = jnp.minimum(wires[i], wires[j])
            hi = jnp.maximum(wires[i], wires[j])
            wires[i], wires[j] = lo, hi
        elif kind == "min":
            wires[i] = jnp.minimum(wires[i], wires[j])
        else:
            wires[j] = jnp.maximum(wires[i], wires[j])
    if rk is None:
        return [wires[w] for w in order]
    return {r: wires[order[r]] for r in rk}


_Q_RANKS = frozenset(range(7, 13))  # sorted-20 ranks that can reach overall rank 12


def median25_select(q: dict, side: list) -> Array:
    """Overall median (rank 12 of 25) from a sorted-20 dict (ranks 7..12) and one
    sorted column of 5, via the two-sorted-list selection identity."""
    t = q[7]
    for k in range(5):
        t = jnp.maximum(t, jnp.minimum(q[8 + k], side[4 - k]))
    return t


def median5_from_padded(xp: Array, h: int, w: int) -> Array:
    """5x5 median field for output rows/cols [0,h)x[0,w) of ``xp``, which must carry
    a 2-pixel halo on every side (shape >= (h+4, w+4); extra right/bottom ignored).

    Shared-column scheme; bit-identical to the direct pruned-network median."""
    s_cols = sort5([xp[..., dy : dy + h, : w + 4] for dy in range(5)])
    pairs = merge_sorted(
        [s[..., :, : w + 3] for s in s_cols], [s[..., :, 1 : w + 4] for s in s_cols]
    )
    q = merge_sorted(
        [p[..., :, :w] for p in pairs],
        [p[..., :, 2 : 2 + w] for p in pairs],
        ranks=_Q_RANKS,
    )
    side = [s[..., :, 4 : 4 + w] for s in s_cols]
    return median25_select(q, side)


def median5(x: Array) -> Array:
    """cv2.medianBlur(src, 5) equivalent for float32 (replicate border).

    Exact 25-element median via shared sorted columns + pruned merges (86 min/max
    ops per pixel vs 202 for the direct pruned network; identical values)."""
    h, w = x.shape[-2], x.shape[-1]
    return median5_from_padded(pad_replicate(x, 2), h, w)


def median3(x: Array) -> Array:
    """cv2.medianBlur(src, 3) equivalent for float32 (replicate border)."""
    return _median_of(_window_views(x, 3, pad_replicate))


def median2(x: Array) -> Array:
    """Reference's 2x2 median (raw_bad_pixel_corr.py:9-28): median of
    {self, E, S, SE} with np.pad-reflect(101) border = mean of the two middle values."""
    xp = pad_reflect101(x, 1)
    h, w = x.shape[-2], x.shape[-1]
    a = xp[..., 1 : 1 + h, 1 : 1 + w]
    b = xp[..., 1 : 1 + h, 2 : 2 + w]
    c = xp[..., 2 : 2 + h, 1 : 1 + w]
    d = xp[..., 2 : 2 + h, 2 : 2 + w]
    # Middle two of four via a 6-op min/max network (no stacked buffer, no sort;
    # the middle values — and their sum — are bit-identical to sorting's).
    lo_ab, hi_ab = jnp.minimum(a, b), jnp.maximum(a, b)
    lo_cd, hi_cd = jnp.minimum(c, d), jnp.maximum(c, d)
    return (jnp.maximum(lo_ab, lo_cd) + jnp.minimum(hi_ab, hi_cd)) * 0.5


def shift2d(x: Array, dy: int, dx: int, pad_fn=pad_reflect) -> Array:
    """Return x sampled at (y+dy, x+dx) with the given border handling."""
    py, px = abs(dy), abs(dx)
    if py == 0 and px == 0:
        return x
    xp = pad_fn(x, (py, py, px, px))
    h, w = x.shape[-2], x.shape[-1]
    return xp[..., py + dy : py + dy + h, px + dx : px + dx + w]


def upsample2x_bilinear_cv2(x: Array) -> Array:
    """cv2.resize(src, (2W, 2H), INTER_LINEAR) equivalent.

    Half-pixel-center bilinear 2x upsample reduces to a fixed 2-tap stencil per output
    parity: even outputs = 0.75*p[i] + 0.25*p[i-1], odd = 0.75*p[i] + 0.25*p[i+1]
    (edges replicate). Used by the Draft demosaic (fast_resize.py:39).
    """

    def up_axis(v: Array, axis: int) -> Array:
        v = jnp.moveaxis(v, axis, -1)
        n = v.shape[-1]
        vp = jnp.pad(v, [(0, 0)] * (v.ndim - 1) + [(1, 1)], mode="edge")
        prev_ = vp[..., 0:n]        # p[i-1]
        cur = vp[..., 1 : n + 1]    # p[i]
        nxt = vp[..., 2 : n + 2]    # p[i+1]
        even = 0.75 * cur + 0.25 * prev_
        odd = 0.75 * cur + 0.25 * nxt
        out = jnp.stack([even, odd], axis=-1).reshape(*v.shape[:-1], 2 * n)
        return jnp.moveaxis(out, -1, axis)

    if x.ndim == 2:
        return up_axis(up_axis(x, 0), 1)
    return up_axis(up_axis(x, -3), -2)  # (H, W, C) or leading batch dims
