"""Image alignment: host shell around the device Lanczos warp.

Replaces the reference's swarp-align transaction (``zuds/swarp.py:107-204``:
write .head file, fork swarp, re-read FITS) with a direct device resample —
no tmpdir, no subprocess, no disk round trip.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .constants import MASK_BIT_NODATA_ALIGN
from .wcs import pixel_mapping
from .ops.resample import upsample_mapping, warp_image, warp_mask

__all__ = ['align_image']


def align_image(image, other, persist_aligned=False):
    """Resample ``image`` onto ``other``'s WCS grid.

    Science-like frames use Lanczos-3; mask frames (``is_mask``) use the
    conservative OR warp and get MASK_BIT_NODATA_ALIGN set outside coverage
    (the reference's bit-16-from-weight-map behavior,
    ``zuds/mask.py:26-33``).
    """
    from .mask import MaskImageBase
    from .image import FITSImage

    h, w = other.shape
    grid = pixel_mapping(image.wcs, other.wcs, (h, w))
    u, v = upsample_mapping(jnp.asarray(grid.u), jnp.asarray(grid.v),
                            grid.shape, grid.step)

    is_mask = isinstance(image, MaskImageBase)
    extension = f'_aligned_to_{other.basename[:-5]}.remap' \
        if other.basename else '_aligned.remap'

    # host-planned fast path: integer pre-shift + residual-window
    # shift-accumulate (no full-frame gathers); generic mappings fall back
    # to the gather warp
    from .ops.resample import plan_warp, warp_planned
    src_shape = tuple(np.asarray(image.data).shape)
    plan = plan_warp(grid, (h, w), src_shape)

    if is_mask:
        # masks promote to 32-bit: the alignment-nodata bit is bit 16
        data = jnp.asarray(np.ascontiguousarray(image.data).astype(np.uint32))
        if plan is not None:
            _, warped_m, cov = warp_planned(
                jnp.zeros(src_shape, jnp.float32), data, u, v, plan, (h, w))
            warped = np.array(warped_m)
            cov_np = np.array(cov)
        else:
            warped = np.array(warp_mask(data, u, v))
            src = jnp.ones(data.shape, dtype=jnp.float32)
            _, cov = warp_image(src, u, v)
            cov_np = np.array(cov)
        warped = np.where(cov_np > 0, warped,
                          warped | np.uint32(1 << MASK_BIT_NODATA_ALIGN))
        result = MaskImageBase()
        out_data = warped.astype(np.int32)
    else:
        data = jnp.asarray(np.ascontiguousarray(image.data).astype(np.float32))
        if plan is not None:
            warped, _, cov = warp_planned(
                data, jnp.zeros(src_shape, jnp.uint32), u, v, plan, (h, w))
        else:
            warped, cov = warp_image(data, u, v)
        result = FITSImage()
        out_data = np.array(warped)
        cov_np = np.array(cov)

    header = other.header.copy()
    # carry photometric / observational keywords from the source frame
    for key in ('MAGZP', 'SEEING', 'OBSMJD', 'OBSJD', 'FILTER', 'FILTERID',
                'EXPTIME', 'SATURATE', 'APCOR4', 'APCOR4ERR', 'FIELDID',
                'CCDID', 'QID', 'MJD-OBS', 'BZP', 'LMT_MG'):
        if key in image.header:
            header.set(key, image.header[key],
                       image.header.comments.get(key, ''))
    other.wcs.to_header(header)
    header.set('NAXIS1', w)
    header.set('NAXIS2', h)

    result.header = header
    result.data = out_data
    result.basename = (image.basename or 'image.fits').replace(
        '.fits', f'{extension}.fits')
    result.parent_image = image
    result.coverage = cov_np
    result._wcs = other.wcs

    if persist_aligned and image.ismapped:
        out = image.local_path.replace('.fits', f'{extension}.fits')
        result.save(out)
    return result
