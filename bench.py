"""Benchmark: full quadrant subtract+detect+photometer chain on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "quadrants/sec/chip", "vs_baseline": N,
   "device": {"platform", "kind", "count"}, "card": "<name>, <power limit>"}

It fails (non-zero exit) when JAX finds no GPU, and when any leg fails.

Baseline: the reference pipeline processes ~1.1 quadrant-chains/sec per
64-core Cori Haswell node (BASELINE.md, derived from nersc/controller.py
sizing: 960 images / 64 ranks / 15 min chunks).

The benchmarked program is the fused batched pipeline on full-size ZTF
quadrants (3080x3072): Lanczos align of the reference + background/rms mesh
x2 + A&L kernel fit (3x3 regions) + spatially-varying convolution subtract +
matched-filter detection + connected components + moments + aperture
photometry of every candidate. Every timed call gets distinct inputs.
"""
import json
import os
import sys
import tempfile
import time

import numpy as np


def _write_bench_frames(d, npairs, H, W, seed=7):
    """Synthetic full-quadrant FITS pairs on disk (cached across runs)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), 'tests'))
    from zuds_tpu.wcs import TPVWCS
    from zuds_tpu.fits import Header, HDU, write_fits

    # ZTF sampling: 1.01"/px, reference coadd seeing ~2.0" (best-epoch
    # 1.7-2.5" window, reference scripts/makeref.py:66), science ~2.8" —
    # in PIXELS here. The r3 scene used FWHM 1.6 px (sigma 0.68 px), far
    # below ZTF's real sampling; Lanczos-warping that leaves residuals on
    # every bright star that no real frame would show.
    see_ref, see_sci = 2.0, 2.8
    marker = os.path.join(d, f'.done_{npairs}_{H}x{W}_{seed}_'
                             f'{see_ref}_{see_sci}_tpv')
    ref_path = os.path.join(d, 'bench_ref_sciimg.fits')
    paths = [os.path.join(d, f'bench_n{i}_sciimg.fits')
             for i in range(npairs)]
    if os.path.exists(marker):
        return ref_path, paths
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    scale = 1.01 / 3600.0
    nstars = 700
    xs = rng.uniform(40, W - 40, nstars)
    ys = rng.uniform(40, H - 40, nstars)
    fluxes = rng.uniform(5000, 50000, nstars)

    def render(px, py, seeing, extra=None):
        img = np.full((H, W), 150.0, dtype='f4')
        sig = seeing / 2.355
        k = 12
        yy, xx = np.mgrid[-k:k + 1, -k:k + 1]
        stars = list(zip(px, py, fluxes))
        if extra:
            stars.append(extra)
        for x, y, f in stars:
            xi, yi = int(round(x)), int(round(y))
            if not (k < xi < W - k - 1 and k < yi < H - k - 1):
                continue
            psf = np.exp(-((xx + xi - x) ** 2 + (yy + yi - y) ** 2)
                         / (2 * sig * sig)) / (2 * np.pi * sig * sig)
            img[yi - k:yi + k + 1, xi - k:xi + k + 1] += (f * psf
                                                          ).astype('f4')
        img += rng.normal(0, 5.0, (H, W)).astype('f4')
        return img

    def write(path, data, wcs, mjd, seeing):
        h = Header()
        wcs.to_header(h)
        h.set('MAGZP', 26.3)
        h.set('OBSMJD', mjd)
        h.set('FIELDID', 679)
        h.set('CCDID', 1)
        h.set('QID', 2)
        h.set('FILTERID', 2)
        h.set('SATURATE', 60000.0)
        h.set('SEEING', seeing)
        h.set('FILENAME', os.path.basename(path))
        write_fits(path, [HDU(h, data)])
        write_fits(path.replace('sciimg', 'mskimg'),
                   [HDU(h.copy(), np.zeros(data.shape, np.uint16))])

    # REAL ZTF degree-4 TPV distortion (captured quadrant header) on the
    # science epochs so the ingest path pays the honest WCS inverse cost;
    # ref = simple WCS (coadd products carry linear WCS headers)
    import json as _json
    from zuds_tpu.fits import Header as _H
    real = _json.load(open(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'tests', 'data',
        'ztf_real_header.json')))
    hh = _H()
    for k, v in {**real['wcs'], **real['meta']}.items():
        hh.set(k, v)
    wcs_sci = TPVWCS.from_header(hh)
    wcs_sci.crval[:] = (150.1, 35.2)
    wcs_sci.crpix[:] = (W / 2 + 0.5, H / 2 + 0.5)
    # ref: same camera orientation (CD), LINEAR PV (coadd product WCS),
    # dithered CRPIX
    pv_lin1 = np.zeros_like(wcs_sci.pv1)
    pv_lin1[1] = 1.0
    pv_lin2 = np.zeros_like(wcs_sci.pv2)
    pv_lin2[1] = 1.0
    wcs_ref = TPVWCS(np.asarray([W / 2 + 2.1, H / 2 - 1.7]),
                     wcs_sci.crval.copy(), wcs_sci.cd.copy(),
                     pv_lin1, pv_lin2)
    ra, dec = wcs_sci.pix2sky_0(xs, ys)
    rx, ry = wcs_ref.sky2pix_0(ra, dec)
    write(ref_path, render(rx, ry, see_ref), wcs_ref, 58300.0, see_ref)
    for i, p in enumerate(paths):
        t = (500.0 + 257 * i, 600.0 + 193 * i, 30000.0)
        write(p, render(xs, ys, see_sci, extra=t), wcs_sci,
              58345.0 + 0.01 * i, see_sci)
    open(marker, 'w').close()
    return ref_path, paths


def main_files(npairs=6, batch=2, standalone=True):
    """files -> catalog throughput: the REAL unit of work (ingest FITS from
    disk, align+subtract+detect+photometer on device, build catalogs) —
    what BASELINE.md's ~1.1 q/s/node measures for the reference. Uses the
    production night driver (scripts/donight.py). ML scoring off (braai
    weights are an external artifact, as in the reference)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), 'scripts'))
    from donight import run_night
    from zuds_tpu.constants import KERNEL_SPATIAL_ORDER
    from zuds_tpu.parallel import PipelineConfig
    from zuds_tpu.parallel.pipeline import make_subtract_detect_pipeline

    H, W = 3080, 3072
    d = os.path.join(tempfile.gettempdir(), 'zuds-bench-files')
    ref_path, paths = _write_bench_frames(d, npairs, H, W)
    cfg = PipelineConfig(height=H, width=W, ksize=15, stamp=41, smax=384,
                         order=KERNEL_SPATIAL_ORDER, nreg=3, max_det=4096,
                         det_cap=1 << 16, deb_cap=1 << 16,
                         interleave=2 if batch % 2 == 0 else 1)
    pipe = make_subtract_detect_pipeline(cfg)
    work = [f'{p} {ref_path}' for p in paths]

    # warmup (compile + caches) on the first batch
    t0 = time.time()
    run_night(work[:batch], batch=batch, ml=False, db=False, cfg=cfg,
              pipe=pipe)
    compile_s = time.time() - t0

    t0 = time.time()
    res = run_night(work, batch=batch, ml=False, db=False, cfg=cfg,
                    pipe=pipe)
    elapsed = time.time() - t0
    nok = sum(1 for _, r in res if not isinstance(r, Exception))
    # every bench frame plants one 30,000-flux transient: a frame with
    # zero surviving detections means the funnel is degenerate
    ndet = [r for _, r in res if not isinstance(r, Exception)]
    qps = len(work) / elapsed
    result = {
        'metric': 'ZTF quadrants/sec/chip, FILES->catalog through the '
                  'batched night driver (FITS ingest + align + subtract '
                  '+ detect + phot + catalog, 3080x3072, A&L 3x3 order 4)',
        'value': round(qps, 3),
        'unit': 'quadrants/sec/chip',
        'vs_baseline': round(qps / 1.1, 2),
        'pairs': len(work),
        'ok': nok,
        'detections_per_frame': ndet,
        'frames_with_detections': sum(1 for n in ndet if n >= 1),
        'fallbacks': res.fallbacks,
    }
    # every frame plants one bright transient; a frame with zero surviving
    # detections is a funnel-recall failure — gate on it so a recall
    # regression cannot pass silently
    result['recall_ok'] = result['frames_with_detections'] == nok
    print(f'# pairs={len(work)} ok={nok} elapsed={elapsed:.2f}s '
          f'warmup={compile_s:.1f}s', file=sys.stderr)
    out = os.environ.get('BENCH_FILES_OUT')
    if out:
        with open(out, 'w') as f:
            json.dump(result, f)
            f.write('\n')
    if not result['recall_ok']:
        print('# RECALL FAILURE: '
              f'{nok - result["frames_with_detections"]} of {nok} frames '
              'lost their planted transient', file=sys.stderr)
    if not standalone:
        return result
    print(json.dumps(result))
    if not result['recall_ok']:
        sys.exit(2)
    return result


def _write_coadd_frames(d, nframes, H, W, seed=21):
    """Synthetic full-quadrant epochs of one field on disk (cached across
    runs): 400 stars, 2" seeing, +-1.5 px dithers, sibling masks."""
    from zuds_tpu.wcs import TPVWCS
    from zuds_tpu.fits import Header, HDU, write_fits

    rng = np.random.default_rng(seed)
    marker = os.path.join(d, f'.done_{nframes}_{H}x{W}_{seed}')
    paths = [os.path.join(d, f'ep{i}_sciimg.fits') for i in range(nframes)]
    if os.path.exists(marker):
        return paths
    os.makedirs(d, exist_ok=True)
    scale = 1.01 / 3600.0
    nstars = 400
    wcs0 = TPVWCS.simple(crval=(150.1, 35.2),
                         crpix=(W / 2 + .5, H / 2 + .5), scale_deg=scale)
    xs = rng.uniform(30, W - 30, nstars)
    ys = rng.uniform(30, H - 30, nstars)
    fl = rng.uniform(8000, 60000, nstars)
    ra, dec = wcs0.pix2sky_0(xs, ys)
    k = 10
    yy, xx = np.mgrid[-k:k + 1, -k:k + 1]
    for i, p in enumerate(paths):
        wcs_e = TPVWCS.simple(
            crval=(150.1, 35.2),
            crpix=(W / 2 + .5 + rng.uniform(-1.5, 1.5),
                   H / 2 + .5 + rng.uniform(-1.5, 1.5)),
            scale_deg=scale)
        ex, ey = wcs_e.sky2pix_0(ra, dec)
        img = np.full((H, W), 150.0, 'f4')
        sig = 2.0 / 2.355
        for x, y, f in zip(ex, ey, fl):
            xi, yi = int(round(x)), int(round(y))
            if not (k < xi < W - k - 1 and k < yi < H - k - 1):
                continue
            psf = np.exp(-((xx + xi - x) ** 2 + (yy + yi - y) ** 2)
                         / (2 * sig * sig)) / (2 * np.pi * sig * sig)
            img[yi - k:yi + k + 1, xi - k:xi + k + 1] += \
                (f * psf).astype('f4')
        img += rng.normal(0, 5.0, (H, W)).astype('f4')
        h = Header()
        wcs_e.to_header(h)
        for kk, v in [('MAGZP', 26.3), ('OBSMJD', 58300.0 + i),
                      ('FIELDID', 679), ('CCDID', 1), ('QID', 2),
                      ('FILTERID', 2), ('SATURATE', 60000.0),
                      ('SEEING', 2.0)]:
            h.set(kk, v)
        h.set('FILENAME', os.path.basename(p))
        write_fits(p, [HDU(h, img)])
        write_fits(p.replace('sciimg', 'mskimg'),
                   [HDU(h.copy(), np.zeros(img.shape, np.uint16))])
    open(marker, 'w').close()
    return paths


def main_coadd(nepochs=8, standalone=True):
    """Epoch-stack coadd throughput through the PRODUCTION path
    (Coadd.from_images -> fused make_coadd_pipeline): FITS ingest, one
    jitted device program per stack (per-epoch background mesh + weight +
    Lanczos warp + CLIPPED combine), product writes. Two distinct stacks
    alternate."""
    import zuds_tpu as zuds

    H, W = 3080, 3072
    d = os.path.join(tempfile.gettempdir(), 'zuds-bench-coadd')
    paths = _write_coadd_frames(d, 2 * nepochs, H, W)

    stacks = [paths[:nepochs], paths[nepochs:]]
    imgs = [[zuds.ScienceImage.from_file(p) for p in s] for s in stacks]

    t0 = time.time()
    zuds.ScienceCoadd.from_images(imgs[0][:nepochs],
                                  os.path.join(d, 'warm.fits'),
                                  calculate_seeing=False)
    compile_s = time.time() - t0

    t0 = time.time()
    iters = 2
    for i in range(iters):
        zuds.ScienceCoadd.from_images(
            imgs[i % 2], os.path.join(d, f'out{i}.fits'),
            calculate_seeing=False)
    elapsed = time.time() - t0
    eps = nepochs * iters / elapsed
    result = {
        'metric': 'ZTF epochs/sec/chip coadded, FILES->stack through '
                  'Coadd.from_images (fused mesh+weight+warp+CLIPPED '
                  'combine, 3080x3072)',
        'value': round(eps, 3),
        'unit': 'epochs/sec/chip',
        'vs_baseline': round(eps / 1.1, 2),
    }
    print(f'# nepochs={nepochs} iters={iters} elapsed={elapsed:.2f}s '
          f'warmup={compile_s:.1f}s', file=sys.stderr)
    if not standalone:
        return result
    print(json.dumps(result))
    return result


def main():
    from zuds_tpu.env import enable_compile_cache, query_cards, require_gpu
    card = query_cards()
    enable_compile_cache()
    devices = require_gpu()
    import jax.numpy as jnp

    from zuds_tpu.parallel import PipelineConfig
    from zuds_tpu.parallel.pipeline import make_subtract_detect_pipeline
    from __graft_entry__ import _synth_inputs

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    H, W = 3080, 3072
    # PARITY configuration: kernel spatial order 4 over 3x3 regions — the
    # reference's hotpants invocation (-ko 4 -nrx 3 -nry 3,
    # zuds/hotpants.py:83-88) and this repo's own KERNEL_SPATIAL_ORDER
    # default. smax=384 gives ~42 stamps/region; each 41px stamp
    # contributes 729 valid-conv pixel rows, so the 736-unknown per-region
    # fit is strongly overdetermined (hotpants uses ~100 smaller substamps
    # per region).
    from zuds_tpu.constants import KERNEL_SPATIAL_ORDER
    cfg = PipelineConfig(height=H, width=W, ksize=15, stamp=41, smax=384,
                         order=KERNEL_SPATIAL_ORDER, nreg=3, max_det=4096,
                         det_cap=1 << 16, deb_cap=1 << 16,
                         interleave=2 if B % 2 == 0 else 1)

    pipe = make_subtract_detect_pipeline(cfg)

    # every timed call gets DISTINCT inputs, so nothing cached from an
    # earlier call can stand in for compute
    iters = 6
    batches = []
    for seed in range(iters + 1):
        args = _synth_inputs(B, H, W, cfg, seed=seed)
        batches.append(tuple(jnp.asarray(a) for a in args))

    # compile + warmup
    t0 = time.time()
    out = pipe(*batches[iters])
    out['diff'].block_until_ready()
    compile_s = time.time() - t0

    t0 = time.time()
    for i in range(iters):
        out = pipe(*batches[i])
    out['diff'].block_until_ready()
    elapsed = time.time() - t0

    qps = B * iters / elapsed
    baseline = 1.1  # reference quadrants/sec/node (BASELINE.md)
    result = {
        'metric': 'ZTF quadrants/sec/chip, full align+subtract+detect+phot '
                  'chain (3080x3072, A&L 3x3 regions order 4)',
        'value': round(qps, 3),
        'unit': 'quadrants/sec/chip',
        'vs_baseline': round(qps / baseline, 2),
        'compile_s': round(compile_s, 3),
        'device': {'platform': devices[0].platform,
                   'kind': devices[0].device_kind, 'count': len(devices)},
        'card': card,
    }
    print(f'# batch={B} iters={iters} elapsed={elapsed:.3f}s '
          f'compile={compile_s:.1f}s card={card} '
          f'detections={int(np.asarray(out["det_n"]).sum())}',
          file=sys.stderr)

    # secondary legs: the files->catalog and coadd chains, in the SAME
    # json line. A failing leg fails the run. Skip with
    # ZUDS_BENCH_EXTRAS=0.
    if os.environ.get('ZUDS_BENCH_EXTRAS', '1') != '0':
        fr = main_files(standalone=False)
        result['files_qps'] = fr['value']
        result['files_vs_baseline'] = fr['vs_baseline']
        result['files_detections_per_frame'] = fr['detections_per_frame']
        result['files_recall_ok'] = fr['recall_ok']
        result['files_fallbacks'] = fr['fallbacks']
        cr = main_coadd(standalone=False)
        result['coadd_eps'] = cr['value']
    print(json.dumps(result))
    if 'files_recall_ok' in result and (not result['files_recall_ok']
                                        or result['files_fallbacks']):
        sys.exit(2)


if __name__ == '__main__':
    if '--files' in sys.argv or '--coadd' in sys.argv:
        from zuds_tpu.env import enable_compile_cache, require_gpu
        enable_compile_cache()
        require_gpu()
    if '--files' in sys.argv:
        args = [a for a in sys.argv[1:] if a != '--files']
        main_files(npairs=int(args[0]) if args else 6)
    elif '--coadd' in sys.argv:
        args = [a for a in sys.argv[1:] if a != '--coadd']
        main_coadd(nepochs=int(args[0]) if args else 8)
    else:
        main()
