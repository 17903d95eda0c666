"""Background / RMS mesh estimation — the SExtractor back.c replacement.

Implements the semantics the reference gets from ``sex`` check-images
(``zuds/sextractor.py:21-26``: BACKGROUND, BACKGROUND_RMS, -BACKGROUND) with
BACK_SIZE=128 and BACK_FILTERSIZE=3 (``zuds/astromatic/sextractor.conf``,
``zuds/swarp.py:69``):

* the frame is tiled into ``box``-px cells; each cell's pixel histogram is
  sigma-clipped (fixed iteration count, jit-friendly) at ±3 sigma around the
  median;
* the cell background is the clipped mean in uncrowded cells and the mode
  estimator ``2.5·median - 1.5·mean`` when clipping removed >20% of sigma
  (crowded field), exactly SExtractor's rule;
* the cell sigma is the clipped standard deviation;
* both meshes are 3x3 median filtered, then bilinearly interpolated back to
  full resolution from cell centers.

All steps are batched jnp ops over the (ncy, ncx, box*box) cell tensor —
one fused XLA program per frame shape, no per-cell host loops.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ['background_mesh', 'interpolate_mesh', 'median_filter_mesh',
           'masked_median']


def masked_median(x, valid, axis=-1):
    """Exact median over ``axis`` counting only ``valid`` entries (sort
    based; use for small axes — the background mesh uses the bisection
    variant below, which is reduction-only, for the 16k-pixel cells)."""
    big = jnp.asarray(jnp.inf, dtype=x.dtype)
    xs = jnp.sort(jnp.where(valid, x, big), axis=axis)
    cnt = jnp.sum(valid, axis=axis, keepdims=True)
    lo = jnp.clip((cnt - 1) // 2, 0, x.shape[axis] - 1)
    hi = jnp.clip(cnt // 2, 0, x.shape[axis] - 1)
    mlo = jnp.take_along_axis(xs, lo, axis=axis)
    mhi = jnp.take_along_axis(xs, hi, axis=axis)
    med = 0.5 * (mlo + mhi)
    return jnp.squeeze(med, axis=axis)


def bisect_median(x, valid, iters=12):
    """Approximate masked median over the last axis by value-space bisection.

    Pure reductions (no sort): ``iters`` halvings of [min, max] give the
    median to range/2^iters — at 16 iterations that is far below the
    background noise level. This is the same spirit as SExtractor's
    histogram-based quantile estimation in back.c.
    """
    big = jnp.asarray(jnp.inf, dtype=x.dtype)
    lo = jnp.min(jnp.where(valid, x, big), axis=-1)
    hi = jnp.max(jnp.where(valid, x, -big), axis=-1)
    half = jnp.sum(valid, axis=-1) * 0.5

    def step(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        cnt = jnp.sum(valid & (x <= mid[..., None]), axis=-1)
        go_up = cnt < half
        return jnp.where(go_up, mid, lo), jnp.where(go_up, hi, mid)

    lo, hi = jax.lax.fori_loop(0, iters, step, (lo, hi))
    return 0.5 * (lo + hi)


def median_filter_mesh(mesh, size=3):
    """size x size median filter with edge replication (BACK_FILTERSIZE)."""
    if size <= 1:
        return mesh
    r = size // 2
    padded = jnp.pad(mesh, r, mode='edge')
    H, W = mesh.shape
    stack = jnp.stack([padded[dy:dy + H, dx:dx + W]
                       for dy in range(size) for dx in range(size)], axis=-1)
    return jnp.median(stack, axis=-1)


@partial(jax.jit, static_argnames=('shape', 'box'))
def interpolate_mesh(mesh, shape, box=128):
    """Bilinear interpolation from cell centers back to pixel resolution."""
    H, W = shape
    ncy, ncx = mesh.shape
    yy = (jnp.arange(H, dtype=jnp.float32) - (box - 1) / 2.0) / box
    xx = (jnp.arange(W, dtype=jnp.float32) - (box - 1) / 2.0) / box
    y0 = jnp.clip(jnp.floor(yy).astype(jnp.int32), 0, ncy - 2) if ncy > 1 \
        else jnp.zeros(H, jnp.int32)
    x0 = jnp.clip(jnp.floor(xx).astype(jnp.int32), 0, ncx - 2) if ncx > 1 \
        else jnp.zeros(W, jnp.int32)
    fy = jnp.clip(yy - y0, 0.0, 1.0)[:, None] if ncy > 1 else jnp.zeros((H, 1))
    fx = jnp.clip(xx - x0, 0.0, 1.0)[None, :] if ncx > 1 else jnp.zeros((1, W))
    y1 = jnp.minimum(y0 + 1, ncy - 1)
    x1 = jnp.minimum(x0 + 1, ncx - 1)
    top = mesh[y0]
    bot = mesh[y1]
    g00, g01 = top[:, x0], top[:, x1]
    g10, g11 = bot[:, x0], bot[:, x1]
    return (g00 * (1 - fy) * (1 - fx) + g01 * (1 - fy) * fx
            + g10 * fy * (1 - fx) + g11 * fy * fx)


@partial(jax.jit, static_argnames=('box', 'filter_size', 'iters'))
def background_mesh(img, valid=None, box=128, filter_size=3, iters=3):
    """Estimate the background and noise maps of one frame.

    Parameters
    ----------
    img : (H, W) float32 frame.
    valid : optional (H, W) bool; False pixels (masked / zero-weight) are
        excluded from the statistics.
    Returns
    -------
    dict with ``back`` (H, W), ``rms`` (H, W), and the filtered meshes
    ``back_mesh``/``rms_mesh`` ((ncy, ncx), for diagnostics/tests).
    """
    H, W = img.shape
    if valid is None:
        valid = jnp.ones_like(img, dtype=bool)
    pad_y = (-H) % box
    pad_x = (-W) % box
    imgp = jnp.pad(img, ((0, pad_y), (0, pad_x)))
    vp = jnp.pad(valid, ((0, pad_y), (0, pad_x)))
    ncy, ncx = imgp.shape[0] // box, imgp.shape[1] // box
    cells = imgp.reshape(ncy, box, ncx, box).transpose(0, 2, 1, 3) \
        .reshape(ncy, ncx, box * box)
    vcells = vp.reshape(ncy, box, ncx, box).transpose(0, 2, 1, 3) \
        .reshape(ncy, ncx, box * box)
    # also reject non-finite pixels
    vcells = vcells & jnp.isfinite(cells)
    cells = jnp.where(vcells, cells, 0.0)

    def stats_of(data):
        def stats(keep):
            n = jnp.maximum(jnp.sum(keep, axis=-1), 1)
            s = jnp.sum(jnp.where(keep, data, 0.0), axis=-1)
            s2 = jnp.sum(jnp.where(keep, data * data, 0.0), axis=-1)
            mean = s / n
            var = jnp.maximum(s2 / n - mean * mean, 0.0)
            return mean, jnp.sqrt(var), n
        return stats

    stats = stats_of(cells)

    # The sigma-clip ITERATIONS run on a strided subsample of each cell:
    # every bisect-median iteration and clip pass is a full-frame
    # reduction, and 3 clip rounds x (12 median bisections + 3 moment
    # passes) cost ~45 frame passes — the subsample cuts
    # that ~5x while a 128^2 cell still keeps ~3300 samples (median
    # sampling error ~sigma/sqrt(N) ~ 0.02 sigma, far inside SExtractor's
    # own cell noise). The stride is ODD (coprime with the cell row
    # period) so samples cycle through every column phase — a stride of 4
    # sampled only columns = 0 (mod 4), aliasing column-periodic CCD
    # structure (bad columns, amplifier pattern) into the clip bounds
    # (ADVICE r3 medium). The FINAL clipped mean/sigma/median are
    # measured at full resolution with the converged bounds.
    sstep = 5 if box * box >= 4096 else 1
    sub = cells[..., ::sstep]
    vsub = vcells[..., ::sstep]
    stats_s = stats_of(sub)

    # degenerate-subsample guard (ADVICE r3): a cell whose valid pixels
    # all fall off the sampling stride would bisect to NaN and collapse
    # the clip window even though it has valid data — such cells skip
    # clipping entirely (keep = all valid pixels)
    subempty = jnp.sum(vsub, axis=-1) == 0

    def clip_step(_, keep):
        med = bisect_median(sub, keep)
        _, sigma, _ = stats_s(keep)
        lo = med[..., None] - 3.0 * sigma[..., None]
        hi = med[..., None] + 3.0 * sigma[..., None]
        return vsub & (sub >= lo) & (sub <= hi)

    keeps = jax.lax.fori_loop(0, iters, clip_step, vsub)
    med_s = bisect_median(sub, keeps)
    _, sigma_s, _ = stats_s(keeps)
    lo = jnp.where(subempty, -jnp.inf, med_s - 3.0 * sigma_s)[..., None]
    hi = jnp.where(subempty, jnp.inf, med_s + 3.0 * sigma_s)[..., None]
    keep = vcells & (cells >= lo) & (cells <= hi)
    mean, sigma, n = stats(keep)
    # final estimators at FULL resolution with the converged keep mask
    # (ADVICE r3: the mode formula and the crowding test previously mixed
    # subsampled medians/sigmas with full-resolution moments)
    med = bisect_median(cells, keep)
    _, sigma0, _ = stats(vcells)

    # SExtractor crowded-field rule: if clipping changed sigma by <20%,
    # the clipped mean is the background; otherwise use the mode estimator.
    uncrowded = subempty | (
        jnp.abs(sigma - sigma0) < 0.2 * jnp.where(sigma0 == 0, 1.0, sigma0))
    back = jnp.where(uncrowded, mean, 2.5 * med - 1.5 * mean)

    # cells with (almost) no valid pixels inherit the global median mesh value
    good_cell = n > box  # at least one row's worth of valid pixels
    ok = jnp.sum(good_cell) > 0
    gback = masked_median(back.ravel(), good_cell.ravel(), axis=0)
    grms = masked_median(sigma.ravel(), good_cell.ravel(), axis=0)
    back = jnp.where(good_cell, back, jnp.where(ok, gback, 0.0))
    sigma = jnp.where(good_cell, sigma, jnp.where(ok, grms, 0.0))

    back_mesh = median_filter_mesh(back, filter_size)
    rms_mesh = median_filter_mesh(sigma, filter_size)
    return {
        'back': interpolate_mesh(back_mesh, (H, W), box),
        'rms': interpolate_mesh(rms_mesh, (H, W), box),
        'back_mesh': back_mesh,
        'rms_mesh': rms_mesh,
    }
