"""chip_smoke.py's phase-2 parity checks, run on the CPU at small sizes:
the same code and float64 oracles (tests/oracles.py) the card runs at full
quadrant size, so a broken comparison shows here first."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def _star_field(rng, H, W, n, sigma=1.4, sky=150.0, noise=5.0):
    yy, xx = np.mgrid[0:H, 0:W]
    xs = rng.uniform(24, W - 24, n)
    ys = rng.uniform(24, H - 24, n)
    fl = rng.uniform(5e3, 5e4, n)
    img = np.full((H, W), sky)
    for x, y, f in zip(xs, ys, fl):
        img += f * np.exp(-((xx - x) ** 2 + (yy - y) ** 2)
                          / (2 * sigma ** 2)) / (2 * np.pi * sigma ** 2)
    return img + rng.normal(0, noise, (H, W)), xs, ys, fl


def test_smoke_warp_parity(rng):
    img, *_ = _star_field(rng, 96, 128, 20)
    chip_smoke.parity_warp(img.astype('f4'))


@pytest.mark.parametrize('order,nreg', [(0, 1), (2, 2)])
def test_smoke_al_fit_parity(rng, order, nreg):
    """Device fit vs per-region float64 lstsq: B0 field and model flux."""
    H = W = 256
    ref, xs, ys, fl = _star_field(rng, H, W, 60, noise=0.0)
    best = np.argsort(fl)[::-1][:46]
    # two stamps closer to the edge than half a stamp: moved inside
    sx = np.concatenate([xs[best], [8.0, W - 9.0]])
    sy = np.concatenate([ys[best], [120.0, 40.0]])
    chip_smoke.parity_al_fit(ref, sx, sy,
                             np.ones(len(sx), bool), ksize=13, stamp=31,
                             order=order, nreg=nreg,
                             seeing_sigma=2.1 / 2.355)


def test_smoke_coadd_parity():
    rng = np.random.default_rng(3)
    base = rng.normal(200.0, 30.0, (48, 64))
    chip_smoke.parity_coadd(base, 8, seed=4)


def test_smoke_labels_parity(rng):
    """Blobs, a long snake and noise speckles: exact partition match."""
    H, W = 160, 200
    diff = rng.normal(0, 1.0, (H, W))
    diff[20:30, 30:40] += 20.0
    diff[100, 10:190] += 20.0                # snake across the frame
    diff[101:140, 189] += 20.0
    diff[60:63, 60:63] += 20.0
    diff[63, 63] += 20.0                     # diagonal-only neighbour
    chip_smoke.parity_labels(diff, np.ones((H, W)))


def test_smoke_aperture_parity(rng):
    import jax.numpy as jnp
    from zuds_tpu.ops.photometry import aperture_photometry_batched
    img, xs, ys, _ = _star_field(rng, 128, 128, 15)
    xs = np.concatenate([xs, [1.2, 126.6]]).astype('f4')   # edge clipping
    ys = np.concatenate([ys, [64.3, 2.1]]).astype('f4')
    out = aperture_photometry_batched(jnp.asarray(img, jnp.float32), None,
                                      None, jnp.asarray(xs),
                                      jnp.asarray(ys), r=3.0)
    chip_smoke.parity_apertures(img.astype('f4'), xs, ys,
                                np.asarray(out['flux']), 3.0)


def test_smoke_report_fails_over_tolerance():
    chip_smoke.report('within', 0.5, 1.0)
    with pytest.raises(AssertionError):
        chip_smoke.report('over', 1.5, 1.0)
    with pytest.raises(AssertionError):
        chip_smoke.report('nan', float('nan'), 1.0)
