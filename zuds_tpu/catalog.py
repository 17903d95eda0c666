"""Pipeline catalogs (reference: zuds/catalog.py).

``PipelineFITSCatalog.from_image`` replaces the SExtractor subprocess + LDAC
round trip (``zuds/catalog.py:95-143``): the detection op runs on device and
the result materializes as a structured numpy array with SExtractor-named
columns, filtered with the same ``kill_flagged`` rules (rows whose isophotal
footprint touches a fatal mask bit or zero-weight pixel are dropped).
"""
from __future__ import annotations

import os

import numpy as np

from .constants import BAD_SUM, DETECT_NSIGMA, MAX_DETECTIONS
from .file import File
from .fits import read_fits, write_fits, table_to_hdu, Header, HDU

__all__ = ['PipelineFITSCatalog', 'PipelineRegionFile']

# SExtractor-compatible output columns (reference: zuds/astromatic/
# sextractor.param). WIN params alias the plain ones (no windowed refit yet).
CATALOG_DTYPE = [
    ('NUMBER', 'i4'),
    ('X_IMAGE', 'f4'), ('Y_IMAGE', 'f4'),
    ('XWIN_IMAGE', 'f4'), ('YWIN_IMAGE', 'f4'),
    ('X_WORLD', 'f8'), ('Y_WORLD', 'f8'),
    ('XWIN_WORLD', 'f8'), ('YWIN_WORLD', 'f8'),
    ('A_IMAGE', 'f4'), ('B_IMAGE', 'f4'), ('THETA_IMAGE', 'f4'),
    ('AWIN_IMAGE', 'f4'), ('BWIN_IMAGE', 'f4'),
    ('ERRAWIN_IMAGE', 'f4'), ('ERRBWIN_IMAGE', 'f4'),
    ('ERRTHETAWIN_IMAGE', 'f4'),
    ('ERRA_WORLD', 'f8'), ('ERRB_WORLD', 'f8'), ('ERRTHETA_WORLD', 'f8'),
    ('ELONGATION', 'f4'), ('FWHM_IMAGE', 'f4'),
    ('FLUX_ISO', 'f4'), ('FLUX_AUTO', 'f4'), ('FLUXERR_AUTO', 'f4'),
    ('FLUX_APER', 'f4'), ('FLUXERR_APER', 'f4'),
    ('MAG_AUTO', 'f4'), ('MAGERR_AUTO', 'f4'),
    ('FLUX_MAX', 'f4'), ('ISOAREA_IMAGE', 'f4'),
    ('MU_MAX', 'f4'), ('BACKGROUND', 'f4'), ('CLASS_STAR', 'f4'),
    ('FLAGS', 'i2'), ('FLAGS_WEIGHT', 'i2'), ('IMAFLAGS_ISO', 'i4'),
    ('GOODCUT', 'i2'), ('RB', 'f4'),
    # filter diagnostics, device-computed by the fused pipeline (r=6
    # aperture sums over the rms / bad-pixel maps and the negative-pixel
    # veto): lets filter_sexcat run from catalog columns alone, with no
    # frame fetch (NEGPIX = -1 means "not precomputed"; filter_sexcat
    # then derives all three from the frames as before)
    ('BPMCUT', 'f4'), ('RMSCUT', 'f4'), ('NEGPIX', 'i2'),
]


class PipelineFITSCatalog(File):
    """Catalog of detections on one image, disk-mapped as a FITS bintable."""

    __diskmapped_cached_properties__ = ['_path', '_data']

    image = None

    @property
    def data(self):
        try:
            return self._data
        except AttributeError:
            self.load()
        return self._data

    @data.setter
    def data(self, value):
        self._data = value

    def __len__(self):
        return len(self.data)

    def load(self):
        hdus = read_fits(self.local_path)
        tables = [h for h in hdus if h.is_table]
        self._data = tables[-1].data
        self.header = tables[-1].header

    def save(self, path=None):
        if path is not None:
            self.map_to_local_file(path)
        header = getattr(self, 'header', None)
        write_fits(self.local_path, [table_to_hdu(self.data, header)])

    @classmethod
    def from_file(cls, fname):
        obj = cls()
        obj.map_to_local_file(fname)
        obj.basename = os.path.basename(fname)
        obj.load()
        return obj

    @classmethod
    def from_image(cls, image, kill_flagged=True, tmpdir=None,
                   nsigma=DETECT_NSIGMA, max_det=MAX_DETECTIONS):
        """Detect sources on ``image`` and build its catalog.

        Runs the device detection op on the background-subtracted frame,
        measures r=3px aperture fluxes in the same pass, attaches the
        segmentation map as ``image.segm_image``, and applies the
        reference's ``kill_flagged`` row filter.
        """
        import jax.numpy as jnp
        from .ops.detect import detect_sources
        from .ops.photometry import aperture_photometry_batched

        bkgsub = np.ascontiguousarray(
            image.background_subtracted_image.data).astype(np.float32)
        rms = np.ascontiguousarray(image.rms_image.data).astype(np.float32)
        if image.mask_image is not None:
            mask = np.ascontiguousarray(image.mask_image.data) \
                .astype(np.uint32)
        else:
            mask = np.zeros(bkgsub.shape, dtype=np.uint32)
        weight_ok = np.asarray(image.weight_image.data) > 0

        out = detect_sources(jnp.asarray(bkgsub), jnp.asarray(rms),
                             jnp.asarray(mask), jnp.asarray(weight_ok),
                             nsigma=nsigma, max_det=max_det)
        valid = np.array(out['valid'])
        idx = np.nonzero(valid)[0]

        xs = np.array(out['x'])[idx]
        ys = np.array(out['y'])[idx]

        phot = aperture_photometry_batched(
            jnp.asarray(bkgsub), jnp.asarray(rms), jnp.asarray(mask),
            jnp.asarray(xs.astype('f4')), jnp.asarray(ys.astype('f4')))
        phot = {k: np.array(v) for k, v in phot.items()}

        obj = cls._build(image, out, idx, phot, bkgsub, rms,
                         kill_flagged=kill_flagged, nsigma=nsigma)

        # attach the segmentation check-image
        seg = np.array(out['labels']).astype(np.int32)
        image._set_product('_segmimg', seg, dtype='i4')

        if image.ismapped:
            obj.map_to_local_file(os.path.join(
                os.path.dirname(image.local_path), obj.basename))
            obj.save()
        image.catalog = obj
        return obj

    @classmethod
    def from_pipeline(cls, image, pout, frame=None, kill_flagged=True,
                      nsigma=DETECT_NSIGMA, save=True):
        """Catalog from fused-pipeline outputs without re-running detection
        (the batched night driver's path, ``scripts/donight.py``).

        ``pout``: output dict of ``make_subtract_detect_pipeline``;
        ``frame``: batch index to select (None when already unbatched).

        Uses ONLY the fixed-size per-detection rows — the windowed refine
        pass, the r=6 filter aperture sums, and the negpix veto all ran on
        device inside the pipeline, so no full frame is touched here (an
        earlier version re-uploaded diff+rms for ``refine_detections``,
        copying ~340 MB per batch between host and device).
        """
        from .ops.detect import DETECTION_FIELDS

        def sel(a):
            a = np.asarray(a)
            return a[frame] if frame is not None else a

        out = {f: sel(pout[f'det_{f}']) for f in DETECTION_FIELDS}
        out['valid'] = sel(pout['det_valid'])
        idx = np.nonzero(out['valid'])[0]
        phot = {k: sel(pout[f'ap_{k}'])[idx]
                for k in ('flux', 'fluxerr', 'flags')}
        ref_meas = {k: sel(pout[f'det_{k}'])[idx]
                    for k in ('xwin', 'ywin', 'kron_radius', 'flux_auto',
                              'fluxerr_auto', 'awin', 'bwin', 'thetawin',
                              'errawin', 'errbwin', 'errthetawin')}
        filter_cols = {
            'BPMCUT': sel(pout['det_bpm_ap'])[idx],
            # RMSCUT is the r=6 aperture MEAN of the rms map
            # (filter_sexcat divides the sum by the aperture area)
            'RMSCUT': sel(pout['det_rms_ap'])[idx] / (np.pi * 36.0),
            'NEGPIX': sel(pout['det_negpix'])[idx].astype('i2'),
        }
        obj = cls._build(image, out, idx, phot, ref_meas=ref_meas,
                         filter_cols=filter_cols,
                         kill_flagged=kill_flagged, nsigma=nsigma)
        obj.header.set('RMSMED', float(sel(pout['rms_med'])),
                       'median unmasked rms (device)')
        for k in ('pix', 'deblend', 'obj'):
            obj.header.set(f'OVF{k.upper()[:5]}',
                           int(sel(pout[f'det_{k}_overflow'])),
                           f'detect {k} capacity overflow (frame total)')
        if save and image.ismapped:
            obj.map_to_local_file(os.path.join(
                os.path.dirname(image.local_path), obj.basename))
            obj.save()
        image.catalog = obj
        return obj

    @classmethod
    def _build(cls, image, out, idx, phot, bkgsub=None, rms=None,
               ref_meas=None, filter_cols=None, kill_flagged=True,
               nsigma=DETECT_NSIGMA):
        """Assemble the structured catalog from detection-op arrays.

        ``out``: detect_sources-style dict of per-row arrays (device or
        numpy); ``idx``: indices of valid rows; ``phot``: r=3px aperture
        photometry at the valid rows. Either ``ref_meas`` (precomputed
        windowed/Kron measures at the valid rows — the fused-pipeline
        path) or ``bkgsub``+``rms`` frames (the refine pass runs here —
        the per-image path) must be provided. ``filter_cols``: optional
        precomputed BPMCUT/RMSCUT/NEGPIX filter diagnostics.
        """
        import jax.numpy as jnp

        n = idx.size
        xs = np.array(out['x'])[idx]
        ys = np.array(out['y'])[idx]

        if ref_meas is None:
            # refined measurements: windowed centroids + Kron AUTO
            # photometry (the fused pipeline computes these on device)
            from .ops.measure import refine_detections
            ref_meas = refine_detections(
                jnp.asarray(bkgsub), jnp.asarray(rms),
                jnp.asarray(xs.astype('f4')), jnp.asarray(ys.astype('f4')),
                jnp.asarray(np.array(out['a'])[idx].astype('f4')),
                jnp.asarray(np.array(out['b'])[idx].astype('f4')),
                jnp.asarray(np.array(out['theta'])[idx].astype('f4')),
                jnp.asarray(np.array(out['fwhm'])[idx].astype('f4')))
        xwin = np.array(ref_meas['xwin'])
        ywin = np.array(ref_meas['ywin'])

        cat = np.zeros(n, dtype=CATALOG_DTYPE)
        cat['NUMBER'] = np.arange(1, n + 1)
        # SExtractor pixel coordinates are FITS 1-based
        cat['X_IMAGE'] = xs + 1.0
        cat['Y_IMAGE'] = ys + 1.0
        cat['XWIN_IMAGE'] = xwin + 1.0
        cat['YWIN_IMAGE'] = ywin + 1.0
        if 'CRVAL1' in image.header:
            ra, dec = image.wcs.pix2sky_0(xs, ys)
            cat['X_WORLD'] = ra
            cat['Y_WORLD'] = dec
            raw, decw = image.wcs.pix2sky_0(xwin, ywin)
            cat['XWIN_WORLD'] = raw
            cat['YWIN_WORLD'] = decw
        for src, dst in [('a', 'A_IMAGE'), ('b', 'B_IMAGE'),
                         ('elongation', 'ELONGATION'),
                         ('fwhm', 'FWHM_IMAGE'), ('flux', 'FLUX_ISO'),
                         ('peak', 'FLUX_MAX'), ('npix', 'ISOAREA_IMAGE')]:
            cat[dst] = np.array(out[src])[idx]
        cat['THETA_IMAGE'] = np.degrees(np.array(out['theta'])[idx])
        # windowed shape + positional-uncertainty ellipse (the columns
        # SCAMP weights its astrometric fit by; reference contract
        # zuds/astromatic/sextractor.param:6-13)
        cat['AWIN_IMAGE'] = np.array(ref_meas['awin'])
        cat['BWIN_IMAGE'] = np.array(ref_meas['bwin'])
        cat['ERRAWIN_IMAGE'] = np.array(ref_meas['errawin'])
        cat['ERRBWIN_IMAGE'] = np.array(ref_meas['errbwin'])
        cat['ERRTHETAWIN_IMAGE'] = np.degrees(
            np.array(ref_meas['errthetawin']))
        # WORLD error ellipse via the local pixel scale (the WCS is a
        # near-conformal tangent projection at ZTF scale, so the error
        # ellipse rotates rigidly; distortion-induced scale variation is
        # <1e-3 across a quadrant)
        try:
            pixscale_deg = image.wcs.pixel_scale_arcsec() / 3600.0
        except Exception:
            pixscale_deg = 1.0 / 3600.0
        cat['ERRA_WORLD'] = cat['ERRAWIN_IMAGE'] * pixscale_deg
        cat['ERRB_WORLD'] = cat['ERRBWIN_IMAGE'] * pixscale_deg
        cat['ERRTHETA_WORLD'] = cat['ERRTHETAWIN_IMAGE']
        cat['FLAGS'] = np.array(out['flags'])[idx] & ~np.int32(1)
        cat['FLAGS_WEIGHT'] = (np.array(out['flags'])[idx] & 1)
        cat['IMAFLAGS_ISO'] = np.array(out['imaflags'])[idx]
        cat['FLUX_APER'] = np.array(phot['flux'])
        cat['FLUXERR_APER'] = np.array(phot['fluxerr'])
        # FLUX_AUTO: Kron elliptical-aperture photometry (PHOT_AUTOPARAMS
        # 2.5, 3.5 semantics)
        cat['FLUX_AUTO'] = np.array(ref_meas['flux_auto'])
        cat['FLUXERR_AUTO'] = np.array(ref_meas['fluxerr_auto'])
        zp = image.header.get('MAGZP', 0.0) or 0.0
        with np.errstate(divide='ignore', invalid='ignore'):
            cat['MAG_AUTO'] = zp - 2.5 * np.log10(
                np.where(cat['FLUX_AUTO'] > 0, cat['FLUX_AUTO'], np.nan))
            cat['MAGERR_AUTO'] = 1.0857 * cat['FLUXERR_AUTO'] \
                / np.where(cat['FLUX_AUTO'] > 0, cat['FLUX_AUTO'], np.nan)
        # MU_MAX: peak surface brightness above background
        # (mag/arcsec^2; sextractor.param column)
        try:
            pixscale = image.wcs.pixel_scale_arcsec()
        except Exception:
            pixscale = 1.0
        with np.errstate(divide='ignore', invalid='ignore'):
            cat['MU_MAX'] = zp - 2.5 * np.log10(
                np.where(cat['FLUX_MAX'] > 0,
                         cat['FLUX_MAX'] / pixscale ** 2, np.nan))
        # BACKGROUND: local mesh background at the object centroid. In
        # the frameless (fused-pipeline) path the image is a subtraction
        # whose background is identically zero by construction — avoid
        # materializing a frame just to read zeros.
        if bkgsub is not None:
            bkg = np.ascontiguousarray(image.background_image.data)
            yi = np.clip(np.round(ys).astype(int), 0, bkg.shape[0] - 1)
            xi = np.clip(np.round(xs).astype(int), 0, bkg.shape[1] - 1)
            cat['BACKGROUND'] = bkg[yi, xi]
        else:
            cat['BACKGROUND'] = 0.0
        # CLASS_STAR: morphological star/galaxy score in [0, 1]. The
        # reference runs SExtractor's pre-trained NNW perceptron
        # (astromatic/default.nnw); here an equivalent-purpose logistic on
        # concentration (FWHM vs frame seeing) and elongation — stars
        # (FWHM ~ seeing, round) score ~1, extended/elongated objects ~0.
        seeing = image.header.get('SEEING')
        if not seeing or not np.isfinite(seeing):
            seeing = float(np.nanmedian(cat['FWHM_IMAGE']))                 if len(cat) else 2.0
        conc = cat['FWHM_IMAGE'] / max(float(seeing), 1e-3)
        z1 = np.clip(-8.0 * (1.25 - conc), -60.0, 60.0)
        z2 = np.clip(-4.0 * (1.6 - cat['ELONGATION']), -60.0, 60.0)
        cat['CLASS_STAR'] = 1.0 / (1 + np.exp(z1)) / (1 + np.exp(z2))
        cat['GOODCUT'] = 0
        cat['RB'] = np.nan
        if filter_cols is not None:
            for k, v in filter_cols.items():
                cat[k] = v
        else:
            cat['BPMCUT'] = np.nan
            cat['RMSCUT'] = np.nan
            cat['NEGPIX'] = -1

        if kill_flagged:
            # reference rules (zuds/catalog.py:118-131): drop rows whose
            # isophotal area touches a fatal mask bit or zero-weight pixel
            good = ((cat['IMAFLAGS_ISO'] & BAD_SUM) == 0) \
                & (cat['FLAGS_WEIGHT'] == 0)
            cat = cat[good]
            cat['NUMBER'] = np.arange(1, len(cat) + 1)

        obj = cls()
        obj.image = image
        obj.header = Header()
        obj.header.set('SEXNNW', False, 'device detection op, not SE')
        obj.header.set('NDETECT', len(cat))
        obj.header.set('NSIGMA', float(nsigma))
        obj.data = cat
        if image.basename:
            obj.basename = image.basename.replace('.fits', '.cat')
        return obj


class PipelineRegionFile(File):
    """DS9 region file rendering of a catalog (reference:
    zuds/catalog.py:12-65): green circles for GOODCUT rows, red otherwise."""

    catalog = None

    @classmethod
    def from_catalog(cls, catalog, path=None):
        obj = cls()
        obj.catalog = catalog
        if catalog.basename:
            obj.basename = catalog.basename.replace('.cat', '.reg')
        lines = ['# Region file format: DS9 version 4.1',
                 'global width=2 font="helvetica 10 normal roman"', 'icrs']
        data = catalog.data
        for row in data:
            color = 'green' if row['GOODCUT'] == 1 else 'red'
            lines.append(
                f"circle({row['X_WORLD']:.7f},{row['Y_WORLD']:.7f},5\") "
                f"# color={color}")
        obj.content = '\n'.join(lines) + '\n'
        if path is None and catalog.ismapped:
            path = catalog.local_path.replace('.cat', '.reg')
        if path is not None:
            obj.map_to_local_file(path)
            obj.save()
        return obj

    def save(self, path=None):
        if path is not None:
            self.map_to_local_file(path)
        with open(self.local_path, 'w') as f:
            f.write(self.content)

    def load(self):
        with open(self.local_path) as f:
            self.content = f.read()
