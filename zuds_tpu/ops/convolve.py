"""Convolution helpers for the op layer."""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ['conv2_same', 'fft_convolve_same', 'DEFAULT_FILTER',
           'gaussian_kernel']

# SExtractor's default.conv pyramid filter (zuds/astromatic/default.conv),
# normalized to unit sum.
DEFAULT_FILTER = np.array([[1.0, 2.0, 1.0],
                           [2.0, 4.0, 2.0],
                           [1.0, 2.0, 1.0]]) / 16.0


def conv2_same(img, kernel, max_taps=49):
    """Direct 2-D 'same' convolution.

    Small kernels run as unrolled shift-FMA taps (zero-padded static
    slices) that XLA fuses into one elementwise pass. Kernels above
    ``max_taps`` fall back to the XLA conv, at HIGHEST precision so that
    an f32 conv does not drop to TF32 on the GPU.
    """
    try:
        k = np.asarray(kernel, dtype=np.float32)
        static = True
    except Exception:          # traced kernel: weights not known at trace
        k = kernel
        static = False
    kh, kw = k.shape
    if static and kh * kw <= max_taps:
        H, W = img.shape
        ry0, ry1 = kh // 2, (kh - 1) // 2
        rx0, rx1 = kw // 2, (kw - 1) // 2
        pad = jnp.pad(img, ((ry0, ry1), (rx0, rx1)))
        out = jnp.zeros_like(img)
        for dy in range(kh):
            for dx in range(kw):
                w = float(k[dy, dx])
                if w == 0.0:
                    continue
                out = out + w * jax.lax.dynamic_slice(
                    pad, (dy, dx), (H, W))
        return out
    img4 = img[None, None, :, :]
    k4 = jnp.asarray(k, dtype=img.dtype)[None, None, :, :]
    out = jax.lax.conv_general_dilated(
        img4, k4, window_strides=(1, 1),
        padding=[(kh // 2, (kh - 1) // 2), (kw // 2, (kw - 1) // 2)],
        dimension_numbers=('NCHW', 'OIHW', 'NCHW'),
        precision=jax.lax.Precision.HIGHEST)
    return out[0, 0]


def fft_convolve_same(img, kernel):
    """FFT-based 'same' convolution for larger kernels (PSF matching)."""
    H, W = img.shape
    kh, kw = kernel.shape
    fh, fw = H + kh - 1, W + kw - 1
    F = jnp.fft.rfft2(img, (fh, fw))
    G = jnp.fft.rfft2(jnp.asarray(kernel, dtype=img.dtype), (fh, fw))
    full = jnp.fft.irfft2(F * G, (fh, fw))
    y0, x0 = kh // 2, kw // 2
    return full[y0:y0 + H, x0:x0 + W]


def gaussian_kernel(sigma, size):
    """Normalized 2-D Gaussian kernel of odd ``size``."""
    r = size // 2
    y, x = jnp.mgrid[-r:r + 1, -r:r + 1]
    g = jnp.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return g / jnp.sum(g)
