"""ZOGY optimal image subtraction in Fourier space.

The second subtraction path required by the rebuild spec (BASELINE.json
north-star; no reference-code equivalent — hotpants was the reference's only
subtraction engine). Implements Zackay, Ofek & Gal-Yam (2016): the proper
difference image D, its PSF P_D, and the matched-filter score image S_corr,
entirely as FFT algebra on device (large batched FFTs).

PSF estimation: sigma-clipped mean of recentered bright-star cutouts
(``estimate_psf_from_stars``), the on-device analogue of the reference's
implicit reliance on SExtractor FWHM + hotpants Gaussians.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ['zogy_subtract', 'estimate_psf_from_stars']


def _psf_to_otf(psf, shape):
    """Center a (k, k) PSF into an (H, W) frame and FFT (origin at (0,0))."""
    H, W = shape
    k = psf.shape[0]
    padded = jnp.zeros(shape, dtype=psf.dtype)
    padded = jax.lax.dynamic_update_slice(padded, psf, (0, 0))
    # roll so the PSF center sits at the origin
    padded = jnp.roll(padded, (-(k // 2), -(k // 2)), axis=(0, 1))
    return jnp.fft.rfft2(padded)


@partial(jax.jit, static_argnames=())
def zogy_subtract(new, ref, psf_new, psf_ref, sigma_new, sigma_ref,
                  f_new=1.0, f_ref=1.0):
    """Proper image subtraction of two aligned, background-subtracted frames.

    Parameters
    ----------
    new, ref : (H, W) background-subtracted aligned frames.
    psf_new, psf_ref : (k, k) normalized PSFs.
    sigma_new, sigma_ref : scalar background noise sigmas.
    f_new, f_ref : photometric zeropoint flux scales.

    Returns dict: ``d`` the proper difference (units of ``new``), ``psf_d``
    its (H, W) PSF (origin-centered), ``s_corr`` the matched-filter score
    (units of sigma), ``f_d`` the difference zeropoint.
    """
    H, W = new.shape
    N = jnp.fft.rfft2(new)
    R = jnp.fft.rfft2(ref)
    Pn = _psf_to_otf(psf_new.astype(new.dtype), (H, W))
    Pr = _psf_to_otf(psf_ref.astype(new.dtype), (H, W))

    sn2 = sigma_new ** 2
    sr2 = sigma_ref ** 2
    fn2 = f_new ** 2
    fr2 = f_ref ** 2

    denom = sn2 * fr2 * jnp.abs(Pr) ** 2 + sr2 * fn2 * jnp.abs(Pn) ** 2
    denom = jnp.maximum(denom, 1e-12 * jnp.max(denom))
    sq = jnp.sqrt(denom)

    D_hat = (f_ref * Pr * N - f_new * Pn * R) / sq
    f_d = f_new * f_ref / jnp.sqrt(sn2 * fr2 + sr2 * fn2)
    P_d_hat = (f_ref * f_new * Pr * Pn) / (f_d * sq)
    d = jnp.fft.irfft2(D_hat, (H, W))

    # matched-filter score: S = F_D * D x P_D  (ZOGY eq. 16-17)
    S_hat = f_d * D_hat * jnp.conj(P_d_hat)
    s = jnp.fft.irfft2(S_hat, (H, W))
    # normalize to units of sigma: var(S) = f_d^2 * sum(P_d^2) given unit-var D
    p_d = jnp.fft.irfft2(P_d_hat, (H, W))
    norm = f_d * jnp.sqrt(jnp.maximum(jnp.sum(p_d * p_d), 1e-20))
    s_corr = s / norm

    return {'d': d, 'psf_d': p_d, 's_corr': s_corr, 'f_d': f_d}


@partial(jax.jit, static_argnames=('size',))
def estimate_psf_from_stars(img, xs, ys, valid, size=25, iters=2):
    """PSF from bright-star cutouts: recenter, normalize, clipped mean.

    xs, ys: (S,) star positions (0-based); valid: (S,) bool padding mask.
    Sub-pixel recentering uses the Fourier shift theorem on each cutout.
    Returns (size, size) unit-sum PSF.
    """
    H, W = img.shape
    half = size // 2
    xi = jnp.clip(jnp.round(xs).astype(jnp.int32) - half, 0, W - size)
    yi = jnp.clip(jnp.round(ys).astype(jnp.int32) - half, 0, H - size)

    def cut(x0, y0, xc, yc):
        c = jax.lax.dynamic_slice(img, (y0, x0), (size, size))
        # subpixel shift to center via Fourier phase ramp
        dx = xc - (x0 + half)
        dy = yc - (y0 + half)
        F = jnp.fft.fft2(c)
        fy = jnp.fft.fftfreq(size)[:, None]
        fx = jnp.fft.fftfreq(size)[None, :]
        F = F * jnp.exp(2j * jnp.pi * (fy * dy + fx * dx))
        return jnp.real(jnp.fft.ifft2(F))

    stamps = jax.vmap(cut)(xi, yi, xs, ys)                       # (S, k, k)
    # local background removal (median of the frame border) + normalize
    border = jnp.concatenate([
        stamps[:, 0, :], stamps[:, -1, :], stamps[:, :, 0], stamps[:, :, -1],
    ], axis=1)
    bkg = jnp.median(border, axis=1)[:, None, None]
    stamps = stamps - bkg
    total = jnp.sum(stamps, axis=(1, 2), keepdims=True)
    good0 = valid & (total[:, 0, 0] > 0)
    stamps = stamps / jnp.where(total > 0, total, 1.0)

    good = good0

    def clip_pass(_, good):
        g = good[:, None, None].astype(stamps.dtype)
        n = jnp.maximum(jnp.sum(g), 1.0)
        mean = jnp.sum(stamps * g, axis=0) / n
        var = jnp.sum((stamps - mean) ** 2 * g, axis=0) / n
        sig = jnp.sqrt(jnp.maximum(var, 1e-20))
        dev = jnp.max(jnp.abs(stamps - mean) / (sig + 1e-12), axis=(1, 2))
        return good0 & (dev < 5.0)

    good = jax.lax.fori_loop(0, iters, clip_pass, good)
    g = good[:, None, None].astype(stamps.dtype)
    psf = jnp.sum(stamps * g, axis=0) / jnp.maximum(jnp.sum(g), 1.0)
    psf = jnp.maximum(psf, 0.0)
    psf = psf / jnp.maximum(jnp.sum(psf), 1e-20)
    return psf
