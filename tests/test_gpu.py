"""Parity checks on the card at mid sizes (marked gpu; skip without one).

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

The full-size run is ``python chip_smoke.py``; these are its phase-2 and
braai checks at sizes that compile in seconds.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from test_smoke_parity import _star_field  # noqa: E402

pytestmark = pytest.mark.gpu


def test_gpu_warp_parity(gpu_device, rng):
    img, *_ = _star_field(rng, 768, 1024, 300)
    chip_smoke.parity_warp(img.astype('f4'))


def test_gpu_al_fit_parity_order4_3x3(gpu_device, rng):
    H = W = 768
    ref, xs, ys, fl = _star_field(rng, H, W, 600, noise=0.0)
    keep = (xs > 30) & (xs < W - 30) & (ys > 30) & (ys < H - 30)
    best = np.argsort(fl[keep])[::-1][:384]
    chip_smoke.parity_al_fit(ref, xs[keep][best], ys[keep][best],
                             np.ones(len(best), bool), ksize=15, stamp=41,
                             order=4, nreg=3, seeing_sigma=2.0 / 2.355)


def test_gpu_coadd_parity(gpu_device):
    base = np.random.default_rng(3).normal(200.0, 30.0, (512, 640))
    chip_smoke.parity_coadd(base, 8, seed=4)


def test_gpu_braai_matches_cpu(gpu_device):
    chip_smoke.phase_braai(n=32)
