"""Lanczos-3 WCS resampling on device — the SWarp replacement.

Covers what the reference shells out to ``swarp`` for (``zuds/swarp.py:
107-204`` align; ``zuds/coadd.py:126-163`` coadd resampling): warping a
science/mask/weight frame onto a target WCS pixel grid.

The host supplies a coarse destination->source mapping grid
(``zuds_tpu.wcs.pixel_mapping``); here it is bilinearly upsampled on device
and applied as a separable 6x6-tap Lanczos-3 interpolation. Interpolation
weights are renormalized to unit sum (documented deviation from SWarp, which
uses the raw kernel; difference is <1e-3 and bias-free).

Masks are warped conservatively: a destination pixel inherits the bitwise OR
of every source mask pixel with non-negligible kernel weight. This is safer
than the reference's Lanczos-on-integer-bitmask approach and supersedes it.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ['upsample_mapping', 'warp_image', 'warp_mask', 'warp_image_mask',
           'box_mask_or', 'lanczos3', 'plan_warp', 'warp_planned',
           'warp_shift_image', 'warp_shift_mask']

SUPPORT = 3  # Lanczos order: 6 taps per axis


def lanczos3(t):
    """Lanczos-3 kernel: sinc(t)·sinc(t/3) on |t|<3, else 0."""
    return jnp.where(jnp.abs(t) < SUPPORT, jnp.sinc(t) * jnp.sinc(t / 3.0),
                     0.0)


@partial(jax.jit, static_argnames=('shape', 'step'))
def upsample_mapping(u_coarse, v_coarse, shape, step):
    """Bilinearly upsample a coarse mapping grid to per-pixel (u, v).

    u/v_coarse: (GH, GW) source coords at dst positions (i*step, j*step).
    Returns float32 (H, W) arrays of source x (u) and source y (v).

    The grid is uniform, so the upsample is a pure broadcast + reshape block
    expansion (each coarse cell -> a step x step block with fixed bilinear
    weights): zero gathers on the misaligned coarse grid.
    """
    H, W = shape

    def interp(g):
        # linear-extrapolation pad so (GH-1)*step always covers H
        g = jnp.concatenate([g, (2 * g[-1:] - g[-2:-1])], axis=0)
        g = jnp.concatenate([g, (2 * g[:, -1:] - g[:, -2:-1])], axis=1)
        gh, gw = g.shape
        a = g[:-1, :-1][:, None, :, None]     # (gh-1, 1, gw-1, 1)
        b = g[:-1, 1:][:, None, :, None]
        c = g[1:, :-1][:, None, :, None]
        d = g[1:, 1:][:, None, :, None]
        fy = (jnp.arange(step, dtype=jnp.float32) / step)[None, :, None,
                                                          None]
        fx = (jnp.arange(step, dtype=jnp.float32) / step)[None, None, None,
                                                          :]
        full = (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
                + c * fy * (1 - fx) + d * fy * fx)
        full = full.reshape((gh - 1) * step, (gw - 1) * step)
        return full[:H, :W]

    return interp(u_coarse), interp(v_coarse)


def _tap_indices(u, v, src_shape):
    Hs, Ws = src_shape
    iu = jnp.floor(u).astype(jnp.int32)
    iv = jnp.floor(v).astype(jnp.int32)
    fu = u - iu
    fv = v - iv
    # coverage: full 6x6 support inside the source frame
    inb = ((iu - (SUPPORT - 1) >= 0) & (iu + SUPPORT <= Ws - 1)
           & (iv - (SUPPORT - 1) >= 0) & (iv + SUPPORT <= Hs - 1))
    return iu, iv, fu, fv, inb


@jax.jit
def warp_image(img, u, v):
    """Lanczos-3 warp of ``img`` to dst grid with source coords (u, v).

    Returns (warped, coverage): coverage is 1.0 where the full interpolation
    support lay inside the source frame, 0.0 otherwise (warped is 0 there) —
    the analogue of SWarp's output weight-map support
    (``zuds/mask.py:26-33`` consumes weight==0 as bit 16).
    """
    Hs, Ws = img.shape
    iu, iv, fu, fv, inb = _tap_indices(u, v, (Hs, Ws))
    iu_c = jnp.clip(iu, SUPPORT - 1, Ws - 1 - SUPPORT)
    iv_c = jnp.clip(iv, SUPPORT - 1, Hs - 1 - SUPPORT)

    acc = jnp.zeros(u.shape, dtype=jnp.float32)
    wacc = jnp.zeros(u.shape, dtype=jnp.float32)
    for dy in range(-SUPPORT + 1, SUPPORT + 1):
        wy = lanczos3(fv - dy)
        rows = iv_c + dy
        for dx in range(-SUPPORT + 1, SUPPORT + 1):
            wx = lanczos3(fu - dx)
            w = wx * wy
            vals = img[rows, iu_c + dx]
            acc = acc + vals * w
            wacc = wacc + w
    out = acc / jnp.where(wacc == 0, 1.0, wacc)
    cov = inb.astype(jnp.float32)
    return out * cov, cov


@jax.jit
def warp_mask(mask, u, v):
    """Conservative bitmask warp: OR of source mask over significant taps.

    A tap is significant if |wx| and |wy| each exceed sqrt(5e-3) — the
    same per-axis rule as :func:`warp_shift_mask`, so gather and
    shift-accumulate paths produce bit-identical masks. Outside coverage,
    returns 0 (callers set the alignment-nodata bit from the coverage
    map).
    """
    Hs, Ws = mask.shape
    iu, iv, fu, fv, inb = _tap_indices(u, v, (Hs, Ws))
    iu_c = jnp.clip(iu, SUPPORT - 1, Ws - 1 - SUPPORT)
    iv_c = jnp.clip(iv, SUPPORT - 1, Hs - 1 - SUPPORT)

    out = jnp.zeros(u.shape, dtype=mask.dtype)
    for dy in range(-SUPPORT + 1, SUPPORT + 1):
        takey = _sig_lanczos(fv - dy)
        rows = iv_c + dy
        for dx in range(-SUPPORT + 1, SUPPORT + 1):
            take = takey & _sig_lanczos(fu - dx)
            vals = mask[rows, iu_c + dx]
            out = out | jnp.where(take, vals, 0).astype(mask.dtype)
    return jnp.where(inb, out, 0).astype(mask.dtype)


def _shift_or(m, k, axis):
    """m | roll(m, ±k) without wraparound contamination (edges padded 0)."""
    z = jnp.zeros_like(m)
    if axis == 0:
        up = jnp.concatenate([m[k:], z[:k]], axis=0)
        dn = jnp.concatenate([z[-k:], m[:-k]], axis=0)
    else:
        up = jnp.concatenate([m[:, k:], z[:, :k]], axis=1)
        dn = jnp.concatenate([z[:, -k:], m[:, :-k]], axis=1)
    return m | up | dn


@partial(jax.jit, static_argnames=('reach',))
def box_mask_or(mask, reach=7):
    """(2*reach+1)^2 sliding bitwise-OR dilation, separable log-doubling.

    Conservative mask propagation for the warp: a destination pixel
    inherits the OR of every source-mask pixel within ``reach`` =
    window+SUPPORT of it — a strict superset of the per-tap significant-
    weight OR (any pixel whose Lanczos weight is nonzero lies within
    window+3). Costs ~12 shifted OR passes instead of 225 tap selects
    (the exact per-tap mask OR dominated the warp's cost)."""
    out = mask
    covered = 0
    step = 1
    while covered < reach:
        k = min(step, reach - covered)
        for axis in (0, 1):
            out = _shift_or(out, k, axis)
        covered += k
        step = covered + 1  # window is now [-covered, covered]; next shift
        # may move by up to covered+1 and stay gap-free
    return out


# L(t) ~ 1 - (10/54) pi^2 t^2 near t=0 (the closed form is 0/0 there).
# NOTE: a phase-trick weight-STACK construction (angle-addition identity,
# shared transcendental fields per axis) halved construction flops but
# slowed the whole program on the accelerator it was first tuned for —
# cheap planes flip XLA's fusion-duplication heuristic into recomputing
# them inside every tap consumer, and lax.optimization_barrier did NOT pin
# them under jit+vmap. The naive per-tap lanczos3() stacks below are
# transcendental-expensive per plane, which is precisely what makes XLA
# materialize them once in device memory.
_TAYLOR_C = np.float32(10.0 / 54.0 * np.pi ** 2)


# per-axis mask-significance threshold: sqrt of the 5e-3 product rule, so
# a tap significant in both axes carries ~the same weight floor
_MASK_TAU = np.float32(np.sqrt(5e-3))

# |lanczos3(t)| > _MASK_TAU solved on the host once: the significant set is
# {|t| < A} u {B < |t| < C} (main lobe + first sidelobe pair; the second
# sidelobe peaks at ~0.064 < tau). Evaluating significance as interval
# tests costs 3 compares per tap instead of the 2 transcendental frame
# passes lanczos3 needs — the separable mask warp runs 30 integer taps, so
# this removes ~60 full-frame sin passes per quadrant.
_SIG_A = np.float32(0.9226250948801125)
_SIG_B = np.float32(1.099650902956955)
_SIG_C = np.float32(1.7405705334521984)


def _sig_lanczos(t):
    """|lanczos3(t)| > _MASK_TAU via host-precomputed interval tests
    (bit-identical decision to thresholding lanczos3 itself away from the
    measure-zero interval edges)."""
    a = jnp.abs(t)
    return (a < _SIG_A) | ((a > _SIG_B) & (a < _SIG_C))


@partial(jax.jit, static_argnames=('window',))
def warp_shift_mask(mask, u, v, window=4):
    """Separable significant-weight OR bitmask warp (shift-accumulate).

    A source pixel's bits reach a destination pixel iff its column Lanczos
    weight and its row Lanczos weight each exceed sqrt(5e-3) in magnitude —
    the separable form of the gather warp's |wx*wy| > 5e-3 rule, chosen so
    the OR decomposes into two passes of 2(window+3)+1 integer taps each
    (vs (2(window+3)+1)^2 fused taps, which dominated the warp's cost).
    Taps outside the 6x6 Lanczos support have exactly zero
    weight, so the result is independent of ``window`` whenever the true
    displacement is within it — the batched pipeline and the per-pair
    align path produce IDENTICAL masks even with different windows.

    Column significance is evaluated at the intermediate row the bit
    propagates through (the two passes commute with the shift), matching
    what a separable resampler physically mixes.
    """
    H, W = mask.shape
    yy = jnp.arange(H, dtype=u.dtype)[:, None]
    xx = jnp.arange(W, dtype=u.dtype)[None, :]
    du = u - xx
    dv = v - yy
    inb = ((u >= SUPPORT - 1) & (u <= W - SUPPORT)
           & (v >= SUPPORT - 1) & (v <= H - SUPPORT))

    lo = -(window + SUPPORT)
    hi = window + SUPPORT
    inner = jnp.zeros(mask.shape, dtype=mask.dtype)
    for dx in range(lo, hi + 1):
        take = _sig_lanczos(du - dx)
        inner = inner | jnp.where(take, jnp.roll(mask, -dx, axis=1),
                                  0).astype(mask.dtype)
    out = jnp.zeros(mask.shape, dtype=mask.dtype)
    for dy in range(lo, hi + 1):
        take = _sig_lanczos(dv - dy)
        out = out | jnp.where(take, jnp.roll(inner, -dy, axis=0),
                              0).astype(mask.dtype)
    return jnp.where(inb, out, 0).astype(mask.dtype)


@partial(jax.jit, static_argnames=('window',))
def warp_shift_image_mask(img, mask, u, v, window=4):
    """Shift-accumulate Lanczos-3 warp for small smooth displacements.

    Same math as ``warp_image_mask`` but expressed as whole-frame shifts
    with per-pixel elementwise weights instead of gathers (full-frame
    gathers per tap were far slower than streamed shifted multiplies on
    the accelerator this was first tuned for). Valid when |u - x| and |v - y| <= ``window`` everywhere
    (callers bound it from the mapping grid); the displacement range plus
    the 6-tap support sets the (2*(window+3))^2 tap count, so keep it for
    alignment-sized offsets and fall back to the gather warp beyond.

    The mask rides through :func:`warp_shift_mask` (separable
    significant-weight OR) — the same function the batched pipeline uses,
    so per-pair and batched submasks agree bit-for-bit.
    """
    out, cov = warp_shift_image(img, u, v, window=window)
    macc = warp_shift_mask(mask, u, v, window=window)
    return out, macc, cov


@partial(jax.jit, static_argnames=('window',))
def warp_shift_image(img, u, v, window=4):
    """Maskless shift-accumulate Lanczos-3 warp (see
    warp_shift_image_mask). The mask taps in the fused variant live in
    the lax.scan CARRY, so XLA cannot dead-code them when the caller
    ignores the mask output (a full set of integer taps per quadrant) —
    callers that propagate masks separately (box_mask_or) use this one.
    Returns (warped, coverage)."""
    H, W = img.shape
    yy = jnp.arange(H, dtype=u.dtype)[:, None]
    xx = jnp.arange(W, dtype=u.dtype)[None, :]
    du = u - xx
    dv = v - yy
    inb = ((u >= SUPPORT - 1) & (u <= W - SUPPORT)
           & (v >= SUPPORT - 1) & (v <= H - SUPPORT))

    lo = -(window + SUPPORT)
    hi = window + SUPPORT
    # hoist the column weight fields: an (ntap, H, W) stack in device
    # memory beat recomputing per-tap weight algebra inside the scan (the
    # phase-trick per-tap form was slower AND took minutes to compile;
    # see the NOTE above lanczos3. The naive transcendental stacks stay.)
    wx = jnp.stack([lanczos3(du - dx) for dx in range(lo, hi + 1)])
    wxsum = jnp.sum(wx, axis=0)
    dys = jnp.arange(lo, hi + 1)

    def row_taps(carry, dy):
        acc, wacc = carry
        wy = lanczos3(dv - dy)
        simg_row = jnp.roll(img, -dy, axis=0)
        for j, dx in enumerate(range(lo, hi + 1)):
            acc = acc + jnp.roll(simg_row, -dx, axis=1) * (wx[j] * wy)
        wacc = wacc + wxsum * wy
        return (acc, wacc), None

    init = (jnp.zeros(img.shape, dtype=jnp.float32),
            jnp.zeros(img.shape, dtype=jnp.float32))
    (acc, wacc), _ = jax.lax.scan(row_taps, init, dys)
    out = acc / jnp.where(wacc == 0, 1.0, wacc)
    cov = inb.astype(jnp.float32)
    return out * cov, cov


def _lanczos3_d(t):
    """d/dt of the Lanczos-3 kernel (exact, for the separable warp's
    cross-term correction). L(t) = sinc(t) sinc(t/3) with sinc(t) =
    sin(pi t)/(pi t);  L'(t) = [pi cos(pi t) sin(pi t/3)/3
    + pi sin(pi t) cos(pi t/3)/3... assembled below via the product rule
    on  L = 3 sin(pi t) sin(pi t/3) / (pi^2 t^2)."""
    pt = jnp.float32(np.pi) * t
    s1, c1 = jnp.sin(pt), jnp.cos(pt)
    s3, c3 = jnp.sin(pt / 3.0), jnp.cos(pt / 3.0)
    t2 = t * t
    num = 3.0 / jnp.float32(np.pi ** 2)
    # L = num * s1 * s3 / t^2
    # L' = num * [ (pi c1 s3 + (pi/3) s1 c3) / t^2 - 2 s1 s3 / t^3 ]
    safe_t2 = jnp.maximum(t2, 1e-12)
    safe_t3 = safe_t2 * jnp.where(jnp.abs(t) < 1e-6, 1.0, t)
    d = num * ((jnp.float32(np.pi) * c1 * s3
                + jnp.float32(np.pi / 3.0) * s1 * c3) / safe_t2
               - 2.0 * s1 * s3 / safe_t3)
    # L'(t) ~ -(20/54) pi^2 t near 0 (odd function)
    d = jnp.where(jnp.abs(t) < 1e-3,
                  -2.0 * _TAYLOR_C * t, d)
    return jnp.where(jnp.abs(t) < SUPPORT, d, 0.0)


@partial(jax.jit, static_argnames=('window', 'order'))
def warp_shift_image_sep(img, u, v, window=4, order=1):
    """Separable two-pass Lanczos-3 warp with cross-term correction.

    Same mapping semantics as :func:`warp_shift_image` but O(ntap) instead
    of O(ntap^2) full-frame work: a horizontal pass with weights evaluated
    at each SOURCE row, a vertical pass at the destination, plus an
    ``order``-th order Taylor correction for the difference between the
    column phase at the destination row and at the source row
    (du(x, y+dy) vs du(x, y)). With dudy = max |du/dy| over the frame
    (optics rotation/shear, ~1e-3 for same-field ZTF pairs), the residual
    error after the first-order term is <= (P*dudy)^2/2 * max|L''| ~ 1e-4
    relative — below the sub-mmag parity budget (tests/test_resample.py
    pins it against the gather warp). Callers should fall back to
    :func:`warp_shift_image` when the host plan reports a large rotation.

    Returns (warped, coverage), identical coverage rule to the other warps.
    """
    H, W = img.shape
    yy = jnp.arange(H, dtype=u.dtype)[:, None]
    xx = jnp.arange(W, dtype=u.dtype)[None, :]
    du = u - xx
    dv = v - yy
    inb = ((u >= SUPPORT - 1) & (u <= W - SUPPORT)
           & (v >= SUPPORT - 1) & (v <= H - SUPPORT))

    lo = -(window + SUPPORT)
    hi = window + SUPPORT
    # HOIST the weight fields (same lesson as warp_shift_image: an
    # (ntap, H, W) stack read back by cheap FMA taps beat inline per-tap
    # weight algebra, which also compiled for minutes)
    wx = jnp.stack([lanczos3(du - dx) for dx in range(lo, hi + 1)])
    wy = jnp.stack([lanczos3(dv - dy) for dy in range(lo, hi + 1)])
    if order >= 1:
        wxd = jnp.stack([_lanczos3_d(du - dx) for dx in range(lo, hi + 1)])

    # horizontal pass AT EACH ROW (phase du evaluated at that row):
    # hp = sum_dx L(du - dx) img(:, x+dx);  hd the L' analogue;
    # ws/wsd their weight sums (for the normalization).
    hp = jnp.zeros(img.shape, jnp.float32)
    hd = jnp.zeros(img.shape, jnp.float32)
    ws = jnp.sum(wx, axis=0)
    wsd = jnp.sum(wxd, axis=0) if order >= 1 else None
    for j, dx in enumerate(range(lo, hi + 1)):
        rolled = jnp.roll(img, -dx, axis=1)
        hp = hp + rolled * wx[j]
        if order >= 1:
            hd = hd + rolled * wxd[j]

    # du/dy of the mapping (smooth; forward difference matches the
    # bilinear-upsampled grid's piecewise-linear structure)
    dudy = jnp.concatenate([u[1:] - u[:-1], u[-1:] - u[-2:-1]], axis=0)

    acc = jnp.zeros(img.shape, jnp.float32)
    wacc = jnp.zeros(img.shape, jnp.float32)
    for j, dy in enumerate(range(lo, hi + 1)):
        # value pass: hp at source row y+dy, phase-corrected to dest row
        corr = (jnp.float32(dy) * dudy) if order >= 1 else None
        hrow = jnp.roll(hp, -dy, axis=0)
        wrow = jnp.roll(ws, -dy, axis=0)
        if order >= 1:
            hrow = hrow - corr * jnp.roll(hd, -dy, axis=0)
            wrow = wrow - corr * jnp.roll(wsd, -dy, axis=0)
        acc = acc + wy[j] * hrow
        wacc = wacc + wy[j] * wrow

    out = acc / jnp.where(wacc == 0, 1.0, wacc)
    cov = inb.astype(jnp.float32)
    return out * cov, cov


@partial(jax.jit, static_argnames=('window', 'order'))
def warp_shift_sep_image_mask(img, mask, u, v, window=4, order=1):
    """Fused separable warp: image (two-pass Lanczos-3 with the
    :func:`warp_shift_image_sep` cross-term correction) + significant-weight
    OR bitmask in one program — the mask taps use the same
    :func:`_sig_lanczos` interval tests :func:`warp_shift_mask` evaluates,
    so the mask output is bit-identical to that function
    (tests/test_resample.py), and the image path is bit-identical to
    :func:`warp_shift_image_sep` (same hoisted weight stacks).

    Returns (warped, mask_warped, coverage).
    """
    H, W = img.shape
    yy = jnp.arange(H, dtype=u.dtype)[:, None]
    xx = jnp.arange(W, dtype=u.dtype)[None, :]
    du = u - xx
    dv = v - yy
    inb = ((u >= SUPPORT - 1) & (u <= W - SUPPORT)
           & (v >= SUPPORT - 1) & (v <= H - SUPPORT))

    lo = -(window + SUPPORT)
    hi = window + SUPPORT
    wx = jnp.stack([lanczos3(du - dx) for dx in range(lo, hi + 1)])
    wy = jnp.stack([lanczos3(dv - dy) for dy in range(lo, hi + 1)])
    if order >= 1:
        wxd = jnp.stack([_lanczos3_d(du - dx) for dx in range(lo, hi + 1)])

    hp = jnp.zeros(img.shape, jnp.float32)
    hd = jnp.zeros(img.shape, jnp.float32)
    ws = jnp.sum(wx, axis=0)
    wsd = jnp.sum(wxd, axis=0) if order >= 1 else None
    inner = jnp.zeros(mask.shape, dtype=mask.dtype)
    for j, dx in enumerate(range(lo, hi + 1)):
        rolled = jnp.roll(img, -dx, axis=1)
        hp = hp + rolled * wx[j]
        if order >= 1:
            hd = hd + rolled * wxd[j]
        # mask significance from the SAME interval tests warp_shift_mask
        # uses (not a threshold on wx[j]): guarantees bit-identity with
        # that entry point even when a tap's |L(t)| sits within f32
        # rounding of _MASK_TAU (advisor r4)
        take = _sig_lanczos(du - dx)
        inner = inner | jnp.where(take, jnp.roll(mask, -dx, axis=1),
                                  0).astype(mask.dtype)

    dudy = jnp.concatenate([u[1:] - u[:-1], u[-1:] - u[-2:-1]], axis=0)

    acc = jnp.zeros(img.shape, jnp.float32)
    wacc = jnp.zeros(img.shape, jnp.float32)
    macc = jnp.zeros(mask.shape, dtype=mask.dtype)
    for j, dy in enumerate(range(lo, hi + 1)):
        corr = (jnp.float32(dy) * dudy) if order >= 1 else None
        hrow = jnp.roll(hp, -dy, axis=0)
        wrow = jnp.roll(ws, -dy, axis=0)
        if order >= 1:
            hrow = hrow - corr * jnp.roll(hd, -dy, axis=0)
            wrow = wrow - corr * jnp.roll(wsd, -dy, axis=0)
        acc = acc + wy[j] * hrow
        wacc = wacc + wy[j] * wrow
        take = _sig_lanczos(dv - dy)
        macc = macc | jnp.where(take, jnp.roll(inner, -dy, axis=0),
                                0).astype(mask.dtype)

    out = acc / jnp.where(wacc == 0, 1.0, wacc)
    cov = inb.astype(jnp.float32)
    mout = jnp.where(inb, macc, 0).astype(mask.dtype)
    return out * cov, mout, cov


@jax.jit
def warp_image_mask(img, mask, u, v):
    """Fused science+mask warp sharing tap geometry. Returns (img, mask, cov)."""
    Hs, Ws = img.shape
    iu, iv, fu, fv, inb = _tap_indices(u, v, (Hs, Ws))
    iu_c = jnp.clip(iu, SUPPORT - 1, Ws - 1 - SUPPORT)
    iv_c = jnp.clip(iv, SUPPORT - 1, Hs - 1 - SUPPORT)

    acc = jnp.zeros(u.shape, dtype=jnp.float32)
    wacc = jnp.zeros(u.shape, dtype=jnp.float32)
    macc = jnp.zeros(u.shape, dtype=mask.dtype)
    for dy in range(-SUPPORT + 1, SUPPORT + 1):
        wy = lanczos3(fv - dy)
        takey = jnp.abs(wy) > _MASK_TAU
        rows = iv_c + dy
        for dx in range(-SUPPORT + 1, SUPPORT + 1):
            wx = lanczos3(fu - dx)
            w = wx * wy
            acc = acc + img[rows, iu_c + dx] * w
            wacc = wacc + w
            mvals = mask[rows, iu_c + dx]
            # per-axis significance rule, identical to warp_shift_mask
            take = takey & (jnp.abs(wx) > _MASK_TAU)
            macc = macc | jnp.where(take, mvals, 0).astype(mask.dtype)
    out = acc / jnp.where(wacc == 0, 1.0, wacc)
    cov = inb.astype(jnp.float32)
    return out * cov, jnp.where(inb, macc, 0).astype(mask.dtype), cov


def plan_warp(grid, out_shape, src_shape, max_window=8):
    """Host-side warp plan: decompose the mapping into an integer median
    offset + a small residual displacement.

    The shift-accumulate warp streams elementwise but only covers
    |src - dst| <= window; generic mappings (coadd union grids, dithered
    alignments) carry a LARGE but nearly-constant offset. Removing the
    integer median offset with a pre-roll reduces them to a small residual
    (optics distortion + rotation), so the shift-accumulate path applies
    instead of the full-frame gather warp.

    Returns (du0, dv0, window) or None when the residual exceeds
    ``max_window`` or the rolled reads would leave the canvas (callers
    fall back to the gather warp).
    """
    import math
    Hs, Ws = src_shape
    Ho, Wo = out_shape
    step = grid.step
    gx = np.arange(grid.u.shape[1], dtype=float) * step
    gy = np.arange(grid.v.shape[0], dtype=float) * step
    u = np.asarray(grid.u, float)
    v = np.asarray(grid.v, float)
    val = ((u >= SUPPORT - 1) & (u <= Ws - SUPPORT)
           & (v >= SUPPORT - 1) & (v <= Hs - SUPPORT))
    if not val.any():
        return None
    du = u - gx[None, :]
    dv = v - gy[:, None]
    du0 = int(round(float(np.median(du[val]))))
    dv0 = int(round(float(np.median(dv[val]))))
    resid = max(np.abs(du[val] - du0).max(), np.abs(dv[val] - dv0).max())
    if resid > max_window:
        return None
    window = max(2, 2 * math.ceil(resid / 2))
    pad = window + SUPPORT
    us = u[val] - du0
    vs = v[val] - dv0
    if (us.min() < pad or us.max() > Wo - pad - 1
            or vs.min() < pad or vs.max() > Ho - pad - 1):
        return None
    return du0, dv0, window


def warp_planned(img, mask, u, v, plan, out_shape):
    """Execute a :func:`plan_warp` plan: embed the source in an
    output-shaped canvas, remove the integer offset with a static roll,
    shift-accumulate the residual, and gate by the ORIGINAL-frame
    coverage rule (identical to the gather warp's)."""
    du0, dv0, window = plan
    Ho, Wo = out_shape
    Hs, Ws = img.shape
    h = min(Hs, Ho)
    w = min(Ws, Wo)
    canvas = jnp.zeros((Ho, Wo), jnp.float32).at[:h, :w].set(
        img[:h, :w].astype(jnp.float32))
    mcanvas = jnp.zeros((Ho, Wo), mask.dtype).at[:h, :w].set(
        mask[:h, :w])
    canvas = jnp.roll(canvas, (-dv0, -du0), axis=(0, 1))
    mcanvas = jnp.roll(mcanvas, (-dv0, -du0), axis=(0, 1))
    out, mw, _ = warp_shift_image_mask(canvas, mcanvas, u - du0, v - dv0,
                                       window=window)
    cov = ((u >= SUPPORT - 1) & (u <= Ws - SUPPORT)
           & (v >= SUPPORT - 1) & (v <= Hs - SUPPORT)).astype(jnp.float32)
    return out * cov, jnp.where(cov > 0, mw, 0).astype(mask.dtype), cov
