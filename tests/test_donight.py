"""End-to-end batched night driver test: >= 4 on-disk FITS pairs through
scripts/donight.run_night (Prefetcher -> prepare_frame_inputs -> fused
pipeline -> catalogs/detections), the production path of SURVEY §7 step 7.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'scripts'))

from zuds_tpu.wcs import TPVWCS
from test_pipeline_e2e import (H, W, SCALE, SEEING_REF, SEEING_SCI, NOISE,
                               synth_field, render_frame, write_frame)


@pytest.fixture(scope='module')
def night_dir(tmp_path_factory):
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp('night')
    xs, ys, fluxes = synth_field(rng)
    # a realistic ~9 px dither between ref and sci pointings: forces the
    # prepare_frame_inputs host integer pre-roll into the max_shift=2
    # warp bucket (the production path; residual > bucket would raise and
    # divert to the per-pair fallback, failing the q/s expectations here)
    wcs_ref = TPVWCS.simple(crval=(150.1, 35.2),
                            crpix=(W / 2 + 9.6, H / 2 - 6.2),
                            scale_deg=SCALE)
    wcs_sci = TPVWCS.simple(crval=(150.1, 35.2),
                            crpix=(W / 2 + 0.5, H / 2 + 0.5),
                            scale_deg=SCALE)
    ra, dec = wcs_sci.pix2sky_0(xs, ys)
    rx, ry = wcs_ref.sky2pix_0(ra, dec)
    ref = render_frame(rx, ry, fluxes, SEEING_REF, rng)
    write_frame(str(d / 'ztf_night_ref_sciimg.fits'), ref, wcs_ref,
                58300.0, seeing_px=SEEING_REF)

    def far_from_stars(x0, y0):
        while np.hypot(xs - x0, ys - y0).min() < 12:
            x0 += 9.0
        return x0, y0

    transients = []
    for i in range(4):
        tx, ty = far_from_stars(100.0 + 70 * i, 120.0 + 60 * i)
        t = (tx, ty, 25000.0)
        sci = render_frame(xs, ys, fluxes, SEEING_SCI, rng, transient=t)
        write_frame(str(d / f'ztf_night{i}_sciimg.fits'), sci, wcs_sci,
                    58345.0 + 0.01 * i, seeing_px=SEEING_SCI)
        transients.append(t)
    np.save(d / 'transients.npy', np.asarray(transients))
    return d


def test_run_night_batched(night_dir):
    from donight import run_night
    from zuds_tpu.parallel import PipelineConfig

    ref = str(night_dir / 'ztf_night_ref_sciimg.fits')
    work = [f'{night_dir}/ztf_night{i}_sciimg.fits {ref}' for i in range(4)]
    # max_det 384: the coverage-edge junk deblends into ~250 roots; a
    # 128-row capacity silently clamped late-raster real sources before
    # the obj_overflow counter existed (found by this very test)
    cfg = PipelineConfig(height=H, width=W, ksize=9, stamp=25, smax=36,
                         order=1, nreg=1, max_det=384, box=128)
    res = run_night(work, batch=2, ml=False, db=False, cfg=cfg)
    assert len(res) == 4
    assert res.fallbacks == 0          # every pair took the batched path
    for path, r in res:
        assert not isinstance(r, Exception), (path, r)
        assert r >= 1, (path, 'transient not detected')

    # products landed next to the science frames, per-pair-path naming
    subs = [f for f in os.listdir(night_dir) if f.startswith('sub.')]
    assert len([f for f in subs if f.endswith('.cat')]) == 4

    # each catalog contains its transient within 2 px
    truths = np.load(night_dir / 'transients.npy')
    from zuds_tpu.catalog import PipelineFITSCatalog
    for i in range(4):
        catf = [f for f in subs
                if f'night{i}' in f and f.endswith('.cat')][0]
        cat = PipelineFITSCatalog.from_file(str(night_dir / catf))
        tx, ty, tf = truths[i]
        dx = cat.data['X_IMAGE'] - 1 - tx
        dy = cat.data['Y_IMAGE'] - 1 - ty
        assert np.hypot(dx, dy).min() < 2.0
        # positional uncertainty columns populate (VERDICT r2 missing #3)
        j = np.argmin(np.hypot(dx, dy))
        assert cat.data['ERRAWIN_IMAGE'][j] > 0
        assert np.isfinite(cat.data['ERRA_WORLD'][j])


def test_run_night_counts_fallbacks(night_dir, monkeypatch):
    """Pairs the batched path cannot take go to the per-pair chain, and
    the night's results count them."""
    import dosub
    from donight import run_night
    from zuds_tpu.parallel import PipelineConfig

    served = []

    def fake_do_one(line, ml=True):
        served.append(line)
        return None, [object(), object()]

    monkeypatch.setattr(dosub, 'do_one', fake_do_one)
    ref = str(night_dir / 'ztf_night_ref_sciimg.fits')
    work = [f'{night_dir}/ztf_night{i}_sciimg.fits {ref}' for i in range(3)]
    # a bucket these frames do not fit: every pair leaves the batched path
    cfg = PipelineConfig(height=H + 8, width=W, ksize=9, stamp=25, smax=36,
                         order=1, nreg=1, max_det=384, box=128)
    res = run_night(work, batch=2, ml=False, db=False, cfg=cfg)
    assert res.fallbacks == 3
    assert len(served) == 3
    assert [r for _, r in res] == [2, 2, 2]
