"""Time the fused pipeline truncated after each stage (on the GPU).

Pinpoints where full-pipeline wall-clock diverges from stage-sum
expectations. Usage: python tools/bisect_pipeline.py [order] [stage ...]
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

    order = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    stages = sys.argv[2:] or ['warp', 'bkg', 'fit', 'apply', 'noise',
                              'detect', 'phot', 'refine', 'aps', None]
    H, W = 3080, 3072
    # mirror bench.py main()'s production config exactly
    base = dict(height=H, width=W, ksize=15, stamp=41, smax=384,
                order=order, nreg=3, max_det=4096,
                det_cap=1 << 16, deb_cap=1 << 16)
    args0 = _synth_inputs(1, H, W, PipelineConfig(**base), seed=0)
    argsj = [jnp.asarray(a) for a in args0]

    prev = 0.0
    for st in stages:
        cfg = PipelineConfig(**base, dbg_stop_after=st)
        pipe = make_subtract_detect_pipeline(cfg)
        t0 = time.time()
        out = pipe(*argsj)
        jax.block_until_ready(out)
        comp = time.time() - t0
        iters = 3
        t0 = time.time()
        for i in range(iters):
            out = pipe(argsj[0] + (i + 1) * 1e-3, *argsj[1:])
        jax.block_until_ready(out)
        per = (time.time() - t0) / iters
        print(f'through {st or "FULL":8s} {per * 1e3:9.2f} ms '
              f'(delta {(per - prev) * 1e3:+9.2f} ms, compile {comp:.0f}s)',
              flush=True)
        prev = per


if __name__ == '__main__':
    main()
