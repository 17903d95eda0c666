"""Bisect detect_sources internals through the full-pipeline compile path.

Truncating INSIDE detect via ``det_dbg_stop_after`` times each detect
stage in its real whole-pipeline fusion context. Baseline 'noise' (pipeline truncated just before detect) is timed
first so deltas isolate the detect stages.

Usage: python tools/bisect_detect_in_pipe.py [iters]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def main():
    import jax
    import jax.numpy as jnp
    from zuds_tpu.parallel import PipelineConfig
    from zuds_tpu.parallel.pipeline import make_subtract_detect_pipeline
    from __graft_entry__ import _synth_inputs

    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    H, W = 3080, 3072
    # mirror bench.py main()'s production config exactly
    base = dict(height=H, width=W, ksize=15, stamp=41, smax=384,
                order=4, nreg=3, max_det=4096,
                det_cap=1 << 16, deb_cap=1 << 16)
    args0 = _synth_inputs(1, H, W, PipelineConfig(**base), seed=0)
    argsj = [jnp.asarray(a) for a in args0]

    all_stages = [('noise', None), (None, 'filt'), (None, 'compact'),
                  (None, 'ccl'), (None, 'cell'), (None, 'deb_pre'),
                  (None, 'deb_lab'), (None, 'deb_seg'), (None, 'deblend'),
                  (None, 'stats'), ('detect', None)]
    names = sys.argv[2:]
    stages = ([s for s in all_stages if (s[0] or f'det:{s[1]}') in names]
              if names else all_stages)
    prev = 0.0
    for outer, det in stages:
        cfg = PipelineConfig(**base, dbg_stop_after=outer,
                             det_dbg_stop_after=det)
        pipe = make_subtract_detect_pipeline(cfg)
        t0 = time.time()
        out = pipe(*argsj)
        jax.block_until_ready(out)
        comp = time.time() - t0
        # stage-unique perturbations: every timed call sees new inputs
        soff = hash((outer, det)) % 997 * 1e-4
        t0 = time.time()
        for i in range(iters):
            out = pipe(argsj[0] + (soff + (i + 1) * 1e-3), *argsj[1:])
        jax.block_until_ready(out)
        per = (time.time() - t0) / iters
        name = outer or f'det:{det}'
        print(f'through {name:12s} {per * 1e3:9.2f} ms '
              f'(delta {(per - prev) * 1e3:+9.2f} ms, compile {comp:.0f}s)',
              flush=True)
        prev = per


if __name__ == '__main__':
    main()
