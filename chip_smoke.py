#!/usr/bin/env python
"""Smoke run of the ZTF quadrant chain on one GPU, at full quadrant size.

    python chip_smoke.py          # phases 0-4 on one card
    python chip_smoke.py --four   # only the 'data'-mesh phase, on four cards

One process drives the card; no child process runs JAX. The run stops at
the first phase that fails, with a non-zero exit and no result line.

  0. device and environment: card name and power limit (nvidia-smi, before
     JAX opens the card), a GPU platform (no CPU fallback), the compile
     cache, and the native FITS library rebuilt from ``native/``.
  1. the fused subtract+detect+photometer program at the parity
     configuration (3080x3072, A&L order 4 over 3x3 regions,
     det_cap = deb_cap = 65536), B=2: compile time, memory analysis, one
     call's wall time and peak device memory; every frame finds its
     planted transient.
  2. parity at full size against the float64 oracles of
     ``tests/oracles.py``, each worst deviation printed beside its
     tolerance (``docs/PARITY_CONTRACT.md``): warp, A&L fit (B0 field and
     model flux), CLIPPED coadd, connected components, apertures.
  3. the night driver (``scripts/donight.py run_night``) on 4 FITS pairs,
     batch 2, braai scoring on with seeded weights: no per-pair fallback,
     every catalog keeps its planted transient, braai scores on the card
     match a CPU float32 run.
  4. ``ScienceCoadd.from_images`` on 8 full-size epochs: product shape,
     MAGZP = 25, finite pixels wherever the weight is positive.

The last line of standard output is the JSON result
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))
sys.path.insert(0, os.path.join(REPO, 'scripts'))

H, W = 3080, 3072
TRANSIENT_FLUX = 30000.0
# docs/PARITY_CONTRACT.md
WARP_RTOL, WARP_ATOL = 3e-5, 5e-3
COADD_RTOL, COADD_ATOL = 2e-4, 2e-3
COADD_W_RTOL, COADD_W_ATOL = 2e-4, 1e-5
APERTURE_RTOL = 2e-4                  # tests/test_photometry_ops.py
# braai on the card vs a CPU float32 run of the same weights: every
# product is pinned to HIGHEST, so only summation order differs
BRAAI_ATOL = 1e-5


def log(msg):
    print(msg, flush=True)


def parity_config(B):
    """The benchmark's parity configuration (bench.py): A&L order 4 over
    3x3 regions (hotpants -ko 4 -nrx 3 -nry 3), 64k detection caps."""
    from zuds_tpu.constants import KERNEL_SPATIAL_ORDER
    from zuds_tpu.parallel import PipelineConfig
    return PipelineConfig(height=H, width=W, ksize=15, stamp=41, smax=384,
                          order=KERNEL_SPATIAL_ORDER, nreg=3, max_det=4096,
                          det_cap=1 << 16, deb_cap=1 << 16,
                          interleave=2 if B % 2 == 0 else 1)


def report(name, worst, tol):
    """Print a deviation beside its tolerance; fail when it exceeds it."""
    ok = bool(np.isfinite(worst) and worst <= tol)
    log(f'  {name}: worst {worst:.3e}  tolerance {tol:.3e}  '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise AssertionError(f'{name}: {worst:.3e} exceeds {tol:.3e}')


def allclose_worst(got, want, rtol, atol):
    """max |got - want| / (atol + rtol |want|): <= 1 is within tolerance."""
    got = np.asarray(got, float)
    want = np.asarray(want, float)
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want)),
                        initial=0.0))


def synth_batch(B, cfg, seed):
    """Pipeline inputs from ``__graft_entry__._synth_inputs`` with one
    transient planted in each science frame, away from every star."""
    from __graft_entry__ import _synth_inputs
    args = list(_synth_inputs(B, cfg.height, cfg.width, cfg, seed=seed))
    rng = np.random.default_rng(seed + 1000)
    sig = 2.0
    r = 12
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    psf = np.exp(-(xx ** 2 + yy ** 2) / (2 * sig ** 2)) / (2 * np.pi * sig ** 2)
    ref = args[2]
    where = []
    for b in range(B):
        while True:
            tx = int(rng.integers(200, cfg.width - 200))
            ty = int(rng.integers(200, cfg.height - 200))
            # clear sky in the reference around the site
            if ref[b, ty - 15:ty + 16, tx - 15:tx + 16].max() < 200.0:
                break
        args[0][b, ty - r:ty + r + 1, tx - r:tx + r + 1] += \
            (TRANSIENT_FLUX * psf).astype('f4')
        where.append((tx, ty))
    return args, where


def found_transients(out, where, tol=2.0):
    """Per frame: is there a valid detection within ``tol`` px of the
    planted transient?"""
    found = []
    for b, (tx, ty) in enumerate(where):
        valid = np.asarray(out['det_valid'][b])
        d = np.hypot(np.asarray(out['det_x'][b])[valid] - tx,
                     np.asarray(out['det_y'][b])[valid] - ty)
        found.append(bool(d.size and d.min() < tol))
    return found


# --------------------------------------------------------------------------
# phase 0
# --------------------------------------------------------------------------

def phase_device(n_cards=1):
    """Card query before JAX opens a card, GPU platform check, compile
    cache. Returns (card text, devices)."""
    from zuds_tpu.env import enable_compile_cache, query_cards, require_gpu
    card = query_cards()
    log(f'[0] card (name, power limit): {card}')
    cache = enable_compile_cache()
    import jax
    devices = require_gpu()
    log(f'[0] jax {jax.__version__}  device_kind {devices[0].device_kind}  '
        f'count {len(devices)}  compile cache {cache}')
    if len(devices) < n_cards:
        raise RuntimeError(f'needs {n_cards} cards, JAX found '
                           f'{len(devices)}')
    return card, devices


def phase_native():
    """Rebuild the native FITS library from the committed source."""
    t0 = time.perf_counter()
    subprocess.run(['make', '-C', os.path.join(REPO, 'native'), '-B'],
                   check=True, capture_output=True, text=True)
    from zuds_tpu.fits import native
    if not native.available():
        raise RuntimeError('native FITS library did not load after build')
    log(f'[0] native FITS library built in {time.perf_counter() - t0:.1f} s')


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------

def phase_chain(cfg, B, device, card):
    """Compile and run the fused program once; returns (pipe, host
    outputs, inputs, transient sites)."""
    import jax
    import jax.numpy as jnp
    from zuds_tpu.parallel.pipeline import make_subtract_detect_pipeline

    pipe = make_subtract_detect_pipeline(cfg)
    warm, _ = synth_batch(B, cfg, seed=0)
    warm = [jnp.asarray(a) for a in warm]
    t0 = time.perf_counter()
    compiled = pipe.lower(*warm).compile()
    compile_s = time.perf_counter() - t0
    log(f'[1] compile {compile_s:.3f} s')
    log(f'[1] memory_analysis: {compiled.memory_analysis()}')
    del warm

    args, where = synth_batch(B, cfg, seed=1)
    dev_args = [jnp.asarray(a) for a in args]
    jax.block_until_ready(dev_args)
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*dev_args))
    wall = time.perf_counter() - t0
    peak = (device.memory_stats() or {}).get('peak_bytes_in_use')
    log(f'[1] one call (B={B}): {wall:.3f} s  peak_bytes_in_use {peak}  '
        f'card {card}')
    host = jax.device_get(out)
    found = found_transients(host, where)
    log(f'[1] detections per frame {np.asarray(host["det_n"]).tolist()}  '
        f'planted transient found {found}')
    if not all(found):
        raise AssertionError(f'planted transient lost: {found}')
    return pipe, host, args, where


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------

def parity_warp(img):
    """Production shift-accumulate warp of a full frame vs the float64
    Lanczos-3 oracle."""
    import jax.numpy as jnp
    from oracles import MMAG, oracle_warp
    from zuds_tpu.ops.resample import warp_shift_image

    Hh, Ww = img.shape
    yy, xx = np.mgrid[0:Hh, 0:Ww].astype(float)
    # a smooth field of sub-pixel + distortion-sized displacements inside
    # the pipeline's max_shift=2 bucket
    u = (xx + 0.37 + 1.5 * (yy / Hh) - 0.6 * (xx / Ww)).astype(np.float32)
    v = (yy - 0.61 + 0.9 * (xx / Ww)).astype(np.float32)
    got, cov = warp_shift_image(jnp.asarray(img, jnp.float32),
                                jnp.asarray(u), jnp.asarray(v), window=2)
    want, cov_o = oracle_warp(np.asarray(img, float), u.astype(float),
                              v.astype(float))
    both = (np.asarray(cov) > 0) & (cov_o > 0)
    got = np.asarray(got)
    report('warp pixels vs float64 Lanczos-3 (|d|/(atol+rtol|x|))',
           allclose_worst(got[both], want[both], WARP_RTOL, WARP_ATOL), 1.0)
    report('warp total flux (relative)',
           abs(got[both].sum() / want[both].sum() - 1.0), MMAG)


def parity_al_fit(ref, xs, ys, sv, ksize, stamp, order, nreg, seeing_sigma):
    """A&L fit at (order, nreg) on a full frame whose science image is
    exactly the reference convolved with a known kernel: the device fit
    against unregularized float64 least squares on the device's surviving
    stamps — B0 (flux-ratio) field at the stamps, and model flux in a
    window at each region's center."""
    import jax.numpy as jnp
    from scipy.signal import fftconvolve
    from oracles import (MMAG, oracle_al_fit, oracle_al_model,
                         oracle_b0_field)
    from zuds_tpu.ops.subtract import (KernelBasis, apply_kernel_fast,
                                       fit_kernel)

    Hh, Ww = ref.shape
    basis = KernelBasis(ksize, seeing_sigma=seeing_sigma)
    dense = np.asarray(basis.dense(), float)
    truth = np.zeros(dense.shape[0])
    truth[0] = 1.13
    truth[3] = 0.04
    truth[7] = -0.025
    ref64 = np.asarray(ref, float)
    sci = sum(c * fftconvolve(ref64, dense[n][::-1, ::-1], mode='same')
              for n, c in enumerate(truth) if c) + 30.0
    ivar = np.full(ref.shape, 1 / 25.0)
    fit = fit_kernel(jnp.asarray(ref64, jnp.float32),
                     jnp.asarray(sci, jnp.float32),
                     jnp.asarray(ivar, jnp.float32),
                     jnp.asarray(xs, jnp.float32),
                     jnp.asarray(ys, jnp.float32), jnp.asarray(sv),
                     basis.gx, basis.gy, basis.sums,
                     jnp.asarray(basis.b0_2d), stamp=stamp, order=order,
                     nreg=nreg)
    coeffs = np.asarray(fit['coeffs'], float)
    ok = np.asarray(fit['stamp_ok'])
    xk = np.asarray(xs, float)[ok]
    yk = np.asarray(ys, float)[ok]
    log(f'  A&L fit: {int(ok.sum())} of {int(np.sum(sv))} stamps kept')
    coeffs_o = oracle_al_fit(ref64, sci, ivar, xk, yk, dense, stamp,
                             order=order, nreg=nreg)
    nb = dense.shape[0]
    f_dev = oracle_b0_field(coeffs, xk, yk, ref.shape, nb, order, nreg)
    f_ora = oracle_b0_field(coeffs_o, xk, yk, ref.shape, nb, order, nreg)
    report('A&L B0 field at stamps (relative)',
           float(np.max(np.abs(f_dev / f_ora - 1.0))), MMAG)

    model = np.asarray(apply_kernel_fast(
        jnp.asarray(ref64, jnp.float32), fit['coeffs'], basis.gx, basis.gy,
        basis.sums, jnp.asarray(basis.b0_2d), order=order, nreg=nreg))
    half = min(64, Hh // (4 * nreg), Ww // (4 * nreg))
    worst = 0.0
    for ri in range(nreg):
        for rj in range(nreg):
            r = ri * nreg + rj
            cy = int((ri + 0.5) * Hh / nreg)
            cx = int((rj + 0.5) * Ww / nreg)
            win = (cy - half, cy + half, cx - half, cx + half)
            m_o = oracle_al_model(ref64, coeffs_o, dense, order, nreg, win)
            m_d = model[win[0]:win[1], win[2]:win[3]]
            flux_d = (m_d - coeffs[r, -1]).sum()
            flux_o = (m_o - coeffs_o[r, -1]).sum()
            worst = max(worst, abs(flux_d / flux_o - 1.0))
    report('A&L model flux per region window (relative)', worst, MMAG)


def parity_coadd(base, nep, seed):
    """CLIPPED combine of an nep-epoch full-size stack vs the float64
    Gruen-semantics oracle."""
    import jax.numpy as jnp
    from oracles import oracle_clipped_coadd
    from zuds_tpu.ops.coadd import clipped_coadd

    rng = np.random.default_rng(seed)
    Hh, Ww = base.shape
    imgs = (base[None] + rng.normal(0, 3.0, (nep, Hh, Ww))).astype('f4')
    imgs[2, 100:103, 200:202] += 500.0              # cosmic ray
    weights = rng.uniform(0.05, 0.2, (nep, Hh, Ww)).astype('f4')
    weights[min(4, nep - 1), :Hh // 8, :] = 0.0     # no-data band
    scales = rng.uniform(0.8, 1.2, nep).astype('f4')
    out = clipped_coadd(jnp.asarray(imgs), jnp.asarray(weights),
                        jnp.asarray(scales))
    got = np.asarray(out['coadd'])
    got_w = np.asarray(out['weight'])
    want, want_w = oracle_clipped_coadd(imgs, weights, scales)
    report('CLIPPED coadd pixels (|d|/(atol+rtol|x|))',
           allclose_worst(got, want, COADD_RTOL, COADD_ATOL), 1.0)
    report('CLIPPED coadd weight (|d|/(atol+rtol|x|))',
           allclose_worst(got_w, want_w, COADD_W_RTOL, COADD_W_ATOL), 1.0)


def parity_labels(diff, rms, nsigma=3.0):
    """8-connected components of the thresholded difference: the op's
    labeling function vs scipy.ndimage.label, exactly."""
    import jax.numpy as jnp
    from oracles import oracle_labels, same_partition
    from zuds_tpu.ops.detect import label_components

    mask = np.isfinite(diff) & (rms > 0) & (diff > nsigma * rms)
    lab_dev = np.asarray(label_components(jnp.asarray(mask)))
    lab_ref, _ = oracle_labels(mask)
    equal, n_ref, n_dev = same_partition(lab_ref, lab_dev, mask)
    log(f'  components: scipy {n_ref}  device {n_dev}  '
        f'({int(mask.sum())} pixels over {nsigma} sigma)')
    report('connected components (mismatched partitions)',
           0.0 if equal else 1.0, 0.0)


def parity_apertures(diff, xs, ys, flux, radius):
    """The chain's own aperture fluxes at its detections vs exact-overlap
    float64 apertures on the same difference frame; error relative to the
    aperture's sum of |pixel| x weight."""
    from oracles import oracle_aperture
    want, scale = oracle_aperture(diff, xs, ys, radius)
    err = np.abs(np.asarray(flux, float) - want) / np.maximum(scale, 1e-30)
    log(f'  apertures compared: {len(xs)}')
    report('aperture flux (|d| / sum|pix|w)', float(np.max(err, initial=0)),
           APERTURE_RTOL)


def phase_parity(cfg, host, args):
    from zuds_tpu.constants import APERTURE_RADIUS_PX

    ref = np.asarray(args[2][0])
    parity_warp(ref)
    valid = np.asarray(args[8][0])
    parity_al_fit(ref, np.asarray(args[6][0])[valid],
                  np.asarray(args[7][0])[valid], np.ones(valid.sum(), bool),
                  cfg.ksize, cfg.stamp, cfg.order, cfg.nreg,
                  seeing_sigma=2.0 / 2.355)
    parity_coadd(ref, 8, seed=5)
    diff = np.asarray(host['diff'][0])
    rms = np.asarray(host['rms'][0])
    parity_labels(diff, rms)
    ok = np.asarray(host['det_valid'][0])
    parity_apertures(diff, np.asarray(host['det_x'][0])[ok],
                     np.asarray(host['det_y'][0])[ok],
                     np.asarray(host['ap_flux'][0])[ok], APERTURE_RADIUS_PX)


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------

def phase_night(cfg, pipe, workdir, npairs=4, batch=2):
    """run_night on npairs full-quadrant FITS pairs with braai on."""
    from bench import _write_bench_frames
    from donight import run_night
    from zuds_tpu.catalog import PipelineFITSCatalog

    d = os.path.join(workdir, 'night')
    t0 = time.perf_counter()
    ref_path, paths = _write_bench_frames(d, npairs, cfg.height, cfg.width)
    log(f'[3] wrote {npairs} pairs in {time.perf_counter() - t0:.1f} s')
    work = [f'{p} {ref_path}' for p in paths]
    t0 = time.perf_counter()
    res = run_night(work, batch=batch, ml=True, db=False, cfg=cfg,
                    pipe=pipe)
    log(f'[3] run_night: {time.perf_counter() - t0:.1f} s  '
        f'results {[r if not isinstance(r, Exception) else repr(r) for _, r in res]}'
        f'  per-pair fallbacks {res.fallbacks}')
    failed = [(p, r) for p, r in res if isinstance(r, Exception)]
    if failed or len(res) != npairs:
        raise AssertionError(f'night failed pairs: {failed}')
    if res.fallbacks:
        raise AssertionError(f'{res.fallbacks} pairs left the batched path')
    kept = []
    scored = []
    for i, p in enumerate(paths):
        # the planted transient of bench._write_bench_frames
        tx, ty = 500.0 + 257 * i, 600.0 + 193 * i
        stem = os.path.basename(p)[:-len('.fits')]
        cats = [f for f in os.listdir(d)
                if f.startswith('sub.') and stem in f and f.endswith('.cat')]
        if len(cats) != 1:
            raise AssertionError(f'{p}: catalogs {cats}')
        cat = PipelineFITSCatalog.from_file(os.path.join(d, cats[0]))
        dist = np.hypot(cat.data['X_IMAGE'] - 1 - tx,
                        cat.data['Y_IMAGE'] - 1 - ty)
        j = int(np.argmin(dist))
        kept.append(bool(dist[j] < 2.0))
        scored.append(bool((cat.data['RB'] >= 0).any()))
        log(f'[3] {stem}: {len(cat.data)} catalog rows, transient at '
            f'{dist[j]:.2f} px, RB {float(cat.data["RB"][j]):.4f}')
    if not all(kept):
        raise AssertionError(f'planted transient lost: {kept}')
    if not all(scored):
        raise AssertionError(f'braai scored no row in some frames: {scored}')


def phase_braai(n=64, seed=3):
    """Seeded braai scores on the card vs a CPU float32 run."""
    import jax
    from zuds_tpu.models.braai import TRIPLET_SHAPE, init_braai, rb_scores

    _, params = init_braai(0)
    trip = np.random.default_rng(seed).normal(
        size=(n,) + TRIPLET_SHAPE).astype('f4')
    trip /= np.linalg.norm(trip.reshape(n, -1), axis=1)[:, None, None, None]
    gpu = np.asarray(rb_scores(params, trip))
    cpu_dev = jax.devices('cpu')[0]
    cpu = np.asarray(rb_scores(jax.device_put(params, cpu_dev),
                               jax.device_put(trip, cpu_dev)))
    report('braai scores, card vs CPU float32 (abs)',
           float(np.max(np.abs(gpu - cpu))), BRAAI_ATOL)


# --------------------------------------------------------------------------
# phase 4
# --------------------------------------------------------------------------

def phase_coadd(workdir, nepochs=8, height=H, width=W):
    import zuds_tpu as zuds
    from bench import _write_coadd_frames
    from zuds_tpu import coadd as coadd_mod
    from zuds_tpu.constants import COADD_ZP

    d = os.path.join(workdir, 'coadd')
    paths = _write_coadd_frames(d, nepochs, height, width)
    imgs = [zuds.ScienceImage.from_file(p) for p in paths]
    _, shape = coadd_mod.coadd_grid(imgs)
    n_pipes = len(coadd_mod._COADD_PIPES)
    t0 = time.perf_counter()
    co = zuds.ScienceCoadd.from_images(imgs, os.path.join(d, 'stack.fits'),
                                       calculate_seeing=False)
    log(f'[4] ScienceCoadd.from_images ({nepochs} epochs): '
        f'{time.perf_counter() - t0:.1f} s  shape {co.data.shape}')
    if len(coadd_mod._COADD_PIPES) == n_pipes:
        raise AssertionError('coadd did not run the fused device program')
    if co.data.shape != shape:
        raise AssertionError(f'coadd shape {co.data.shape} != {shape}')
    if co.header['MAGZP'] != COADD_ZP:
        raise AssertionError(f'MAGZP {co.header["MAGZP"]} != {COADD_ZP}')
    wgt = np.asarray(co.weight_image.data)
    pos = wgt > 0
    nbad = int((~np.isfinite(co.data[pos])).sum())
    log(f'[4] weight > 0 on {pos.mean():.4f} of the frame; '
        f'non-finite there: {nbad}')
    if not pos.any() or nbad:
        raise AssertionError('coadd has no weight or non-finite pixels')


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------

def phase_mesh(devices):
    """B=4 full quadrants sharded over a 4-card 'data' mesh vs the same
    frames on one card."""
    import jax
    import jax.numpy as jnp
    from zuds_tpu.parallel import quadrant_mesh, shard_batch
    from zuds_tpu.parallel.pipeline import make_subtract_detect_pipeline

    B = 4
    cfg = parity_config(1)
    args, where = synth_batch(B, cfg, seed=2)
    mesh = quadrant_mesh(n_data=4, n_space=1, devices=devices[:4])
    pipe = make_subtract_detect_pipeline(cfg, mesh=mesh)
    with mesh:
        sharded = shard_batch(mesh, *args)
        t0 = time.perf_counter()
        out = jax.block_until_ready(pipe(*sharded))
        log(f'[4x] mesh call incl. compile: {time.perf_counter() - t0:.1f} s')
    spans = {s.device for s in out['diff'].addressable_shards}
    log(f'[4x] diff shards on {len(spans)} devices: '
        f'{sorted(d.id for d in spans)}')
    if len(spans) != 4:
        raise AssertionError('outputs do not span four devices')
    host = jax.device_get(out)
    one = make_subtract_detect_pipeline(cfg)
    single = jax.device_get(jax.block_until_ready(
        one(*[jax.device_put(jnp.asarray(a), devices[0]) for a in args])))
    found = found_transients(host, where)
    n_mesh = np.asarray(host['det_n']).tolist()
    n_one = np.asarray(single['det_n']).tolist()
    log(f'[4x] detections mesh {n_mesh}  one card {n_one}  '
        f'transients {found}')
    if n_mesh != n_one or not all(found):
        raise AssertionError('mesh and one-card runs disagree')
    report('mesh vs one-card difference images (|d|/(atol+rtol|x|))',
           allclose_worst(host['diff'], single['diff'], WARP_RTOL,
                          WARP_ATOL), 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four', action='store_true',
                    help='run only the four-card data-mesh phase')
    opts = ap.parse_args(argv)
    t_start = time.perf_counter()
    card, devices = phase_device(4 if opts.four else 1)
    if opts.four:
        phase_mesh(devices)
    else:
        phase_native()
        B = 2
        cfg = parity_config(B)
        pipe, host, args, _ = phase_chain(cfg, B, devices[0], card)
        log('[2] parity against float64 oracles')
        phase_parity(cfg, host, args)
        del host, args
        with tempfile.TemporaryDirectory(prefix='zuds-smoke-') as work:
            phase_night(cfg, pipe, work)
            phase_braai()
            phase_coadd(work)
    log(f'all phases passed in {time.perf_counter() - t_start:.1f} s')
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform, 'kind': devices[0].device_kind,
        'count': len(devices)}}), flush=True)


if __name__ == '__main__':
    main()
