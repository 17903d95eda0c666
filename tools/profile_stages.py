"""Per-stage device timing of the fused pipeline on the GPU.

Each stage runs ``iters`` times inside ONE jitted lax.scan with the input
perturbed per iteration (a single device program with chained distinct
iterations keeps per-call host syncs out of the timing).

Usage: python tools/profile_stages.py [iters]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def timed_scan(stage_fn, x0, iters, extra_sync=None):
    """Time stage_fn(frame)->scalar chained over `iters` distinct inputs."""
    import jax
    import jax.numpy as jnp

    def body(c, i):
        s = stage_fn(c)
        # fold the output scalar back so iterations are serially dependent
        return x0 + (s * 1e-20 + i * 1e-6), None

    run = jax.jit(lambda x: jax.lax.scan(
        body, x, jnp.arange(iters, dtype=jnp.float32))[0])
    t0 = time.time()
    out = run(x0)
    out.block_until_ready()
    compile_s = time.time() - t0
    t0 = time.time()
    out = run(x0 + 1.0)
    out.block_until_ready()
    run_s = time.time() - t0
    return run_s / iters, compile_s


def main():
    import jax
    import jax.numpy as jnp

    from zuds_tpu.parallel import PipelineConfig
    from zuds_tpu.parallel.pipeline import make_subtract_detect_pipeline
    from zuds_tpu.ops.resample import upsample_mapping, warp_shift_image_mask
    from zuds_tpu.ops.background import background_mesh, bisect_median
    from zuds_tpu.ops.detect import detect_sources
    from zuds_tpu.ops.photometry import aperture_photometry_batched
    from zuds_tpu.ops.subtract import fit_kernel, apply_kernel
    sys.path.insert(0, '.')
    from __graft_entry__ import _synth_inputs

    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    H, W = 3080, 3072
    cfg = PipelineConfig(height=H, width=W, ksize=15, stamp=41, smax=256,
                         order=2, nreg=3, max_det=1024)
    args = _synth_inputs(1, H, W, cfg, seed=0)
    (sci, sci_mask, ref, ref_mask, gu, gv, sx, sy, sv,
     bgx, bgy, bsums, b0) = [jnp.asarray(a[0]) for a in args]
    print(f'device: {jax.devices()[0]}', file=sys.stderr)

    results = {}

    def report(name, fn, x0):
        per, comp = timed_scan(fn, x0, iters)
        results[name] = per
        print(f'{name:42s} {per * 1e3:9.2f} ms  (compile {comp:.1f}s)',
              flush=True)

    # 1. mapping upsample + warp (the align stage)
    u, v = upsample_mapping(gu, gv, (H, W), cfg.map_step)

    def warp_stage(x):
        refw, refm, cov = warp_shift_image_mask(
            x, ref_mask.astype(jnp.uint32), u, v, window=cfg.max_shift)
        return jnp.sum(refw) + jnp.sum(cov)
    report('warp_shift (window=4, 15x15 taps)', warp_stage, ref)

    def upsample_stage(x):
        uu, vv = upsample_mapping(gu + x[0, 0], gv, (H, W), cfg.map_step)
        return jnp.sum(uu) + jnp.sum(vv)
    report('upsample_mapping', upsample_stage, ref)

    # 2. background mesh
    def bkg_stage(x):
        r = background_mesh(x, None, box=cfg.box)
        return jnp.sum(r['back'][::64, ::64]) + jnp.sum(r['rms'][::64, ::64])
    report('background_mesh (box=128)', bkg_stage, sci)

    # 3. global robust sigma of the ref (bisect median + MAD)
    def gsig_stage(x):
        flat = x.ravel()[None, :]
        okf = jnp.ones_like(flat, dtype=bool)
        med = bisect_median(flat, okf)[0]
        absdev = jnp.abs(x - med).ravel()[None, :]
        mad = bisect_median(absdev, okf)[0]
        return med + mad
    report('global bisect median+MAD', gsig_stage, ref)

    # 4/5. kernel fit at order 2 and 4
    ivar = jnp.full((H, W), 1.0 / 50.0)

    for order in (2, 4):
        def fit_stage(x, order=order):
            f = fit_kernel(ref, x, ivar, sx, sy, sv, bgx, bgy, bsums, b0,
                           stamp=cfg.stamp, order=order, nreg=cfg.nreg)
            return jnp.sum(f['coeffs'][:, 0])
        report(f'fit_kernel (order={order}, nreg=3, S=256)', fit_stage, sci)

    # 6. apply kernel at order 2 and 4
    from zuds_tpu.ops.subtract import spatial_terms
    for order in (2, 4):
        nm = len(spatial_terms(order))
        coeffs = jnp.asarray(
            np.random.default_rng(0).normal(
                0, 0.01, (9, bgx.shape[0] * nm + 1)).astype('f4'))

        def apply_stage(x, coeffs=coeffs, order=order):
            m = apply_kernel(x, coeffs, bgx, bgy, bsums, b0,
                             order=order, nreg=cfg.nreg)
            return jnp.sum(m[::64, ::64])
        report(f'apply_kernel (order={order}, nreg=3)', apply_stage, ref)

    # 7. detection
    rms = jnp.full((H, W), 7.0)
    msk = jnp.zeros((H, W), jnp.uint32)
    okm = jnp.ones((H, W), bool)

    def det_stage(x):
        d = detect_sources(x - 150.0, rms, msk, okm, nsigma=cfg.nsigma,
                           max_det=cfg.max_det, return_labels=False)
        return jnp.sum(d['flux']) + d['n'].astype(jnp.float32)
    report('detect_sources (max_det=1024)', det_stage, sci)

    # 8. aperture photometry at 1024 positions
    px = jnp.asarray(np.random.default_rng(1).uniform(30, W - 30, 1024),
                     jnp.float32)
    py = jnp.asarray(np.random.default_rng(2).uniform(30, H - 30, 1024),
                     jnp.float32)

    def phot_stage(x):
        p = aperture_photometry_batched(x, rms, msk, px, py)
        return jnp.sum(p['flux'])
    report('aperture_photometry (1024 srcs)', phot_stage, sci)

    # 9. full pipeline (batch inside the scan body is just B=1)
    for order in (2, 4):
        cfg_o = PipelineConfig(height=H, width=W, ksize=15, stamp=41,
                               smax=256, order=order, nreg=3, max_det=1024)
        pipe = make_subtract_detect_pipeline(cfg_o)
        argsb = [jnp.asarray(a) for a in args]

        def full_stage(x, pipe=pipe, argsb=argsb):
            out = pipe(x[None], *argsb[1:])
            return jnp.sum(out['diff'][:, ::64, ::64]) + jnp.sum(
                out['ap_flux'])
        report(f'FULL pipeline (order={order})', full_stage, sci)

    total = sum(v for k, v in results.items()
                if not k.startswith(('FULL', 'fit_kernel (order=4',
                                     'apply_kernel (order=4')))
    print(f'\nsum of order-2 stages: {total * 1e3:.2f} ms '
          f'-> {1.0 / total:.2f} q/s', file=sys.stderr)


if __name__ == '__main__':
    main()
