"""zuds_tpu — accelerator-native transient-discovery pipeline for ZTF.

A ground-up rebuild of the ZUDS pipeline with the astromatic/hotpants
subprocess kernels replaced by JAX/XLA device ops batched over ZTF
quadrants, run on an NVIDIA GPU. Public API mirrors the reference's flat namespace
(``zuds/__init__.py:6-42``).
"""
__version__ = '0.1.0'

from .constants import *          # noqa: F401,F403
from .status import status        # noqa: F401
from .secrets import get_secret, load_config  # noqa: F401
from .utils import (              # noqa: F401
    fid_map, get_time, quick_background_estimate, initialize_directory,
    ensure_images_have_the_same_properties,
)
from .fits import Header, HDU, read_fits, write_fits  # noqa: F401

# Modules below are imported lazily on attribute access to keep
# `import zuds_tpu` fast (JAX only loads when device ops are used).
_LAZY_MODULES = {
    'ops': 'zuds_tpu.ops',
    'models': 'zuds_tpu.models',
    'parallel': 'zuds_tpu.parallel',
    'wcs': 'zuds_tpu.wcs',
    'db': 'zuds_tpu.db',
}

_LAZY_SYMBOLS = {
    # symbol -> module that defines it
    'TPVWCS': 'zuds_tpu.wcs',
    'timed': 'zuds_tpu.tracing',
    'device_profile': 'zuds_tpu.tracing',
    'File': 'zuds_tpu.file',
    'UnmappedFileError': 'zuds_tpu.file',
    'FITSFile': 'zuds_tpu.fitsfile',
    'HasWCS': 'zuds_tpu.fitsfile',
    'FITSImage': 'zuds_tpu.image',
    'CalibratableImageBase': 'zuds_tpu.image',
    'CalibratableImage': 'zuds_tpu.image',
    'CalibratedImage': 'zuds_tpu.image',
    'ScienceImage': 'zuds_tpu.image',
    'MaskImageBase': 'zuds_tpu.mask',
    'MaskImage': 'zuds_tpu.mask',
    'PipelineFITSCatalog': 'zuds_tpu.catalog',
    'PipelineRegionFile': 'zuds_tpu.catalog',
    'Coadd': 'zuds_tpu.coadd',
    'ReferenceImage': 'zuds_tpu.coadd',
    'ScienceCoadd': 'zuds_tpu.coadd',
    'Subtraction': 'zuds_tpu.subtraction',
    'SingleEpochSubtraction': 'zuds_tpu.subtraction',
    'MultiEpochSubtraction': 'zuds_tpu.subtraction',
    'sub_name': 'zuds_tpu.subtraction',
    'aperture_photometry': 'zuds_tpu.photometry',
    'raw_aperture_photometry': 'zuds_tpu.photometry',
    'ForcedPhotometry': 'zuds_tpu.photometry',
    'estimate_seeing': 'zuds_tpu.seeing',
    'Detection': 'zuds_tpu.detections',
    'RealBogus': 'zuds_tpu.detections',
    'filter_sexcat': 'zuds_tpu.filterobjects',
    'Source': 'zuds_tpu.source',
    'Thumbnail': 'zuds_tpu.thumbnails',
    'Alert': 'zuds_tpu.alert',
    'xmatch': 'zuds_tpu.crossmatch',
    'send_alert': 'zuds_tpu.send',
    'DBSession': 'zuds_tpu.core',
    'RefDBSession': 'zuds_tpu.core',
    'TapeCopy': 'zuds_tpu.archive',
    'Base': 'zuds_tpu.core',
    'ZTFFile': 'zuds_tpu.core',
    'init_db': 'zuds_tpu.model_util',
    'create_tables': 'zuds_tpu.model_util',
    'drop_tables': 'zuds_tpu.model_util',
    'get_my_share_of_work': 'zuds_tpu.mpi',
    'run_align': 'zuds_tpu.swarp',
    'prepare_swarp_sci': 'zuds_tpu.swarp',
    'prepare_swarp_mask': 'zuds_tpu.swarp',
    'prepare_swarp_align': 'zuds_tpu.swarp',
    'run_sextractor': 'zuds_tpu.sextractor',
    'prepare_sextractor': 'zuds_tpu.sextractor',
    'prepare_hotpants': 'zuds_tpu.hotpants',
    'calibrate_astrometry': 'zuds_tpu.scamp',
    'check_dependencies': 'zuds_tpu.env',
    'join_model': 'zuds_tpu.core',
    'SpatiallyIndexed': 'zuds_tpu.spatial',
    'HasPoly': 'zuds_tpu.spatial',
    'DR8North': 'zuds_tpu.external',
    'DR8South': 'zuds_tpu.external',
    'CLU': 'zuds_tpu.external',
    'ZTFFileCopy': 'zuds_tpu.archive',
    'TapeArchive': 'zuds_tpu.archive',
    'combine_schemas': 'zuds_tpu.send',
    'safe_download': 'zuds_tpu.download',
    'ipac_authenticate': 'zuds_tpu.download',
    'make_triplet_for_braai': 'zuds_tpu.filterobjects',
    'load_model_helper': 'zuds_tpu.filterobjects',
    'JobImage': 'zuds_tpu.joins',
    'CoaddImage': 'zuds_tpu.joins',
    'StackedSubtractionFrame': 'zuds_tpu.joins',
    'get_nthreads': 'zuds_tpu.mpi',
    'Job': 'zuds_tpu.bookkeeping',
    'ForcePhotJob': 'zuds_tpu.bookkeeping',
    'AlertJob': 'zuds_tpu.bookkeeping',
    'FailedSubtraction': 'zuds_tpu.bookkeeping',
    'show_images': 'zuds_tpu.plotting',
    'plot_triplet': 'zuds_tpu.plotting',
    'discrete_cmap': 'zuds_tpu.plotting',
    'to_json': 'zuds_tpu.json_util',
    'archive': 'zuds_tpu.archive',
    'HTTPArchiveCopy': 'zuds_tpu.archive',
    'TapeCopy': 'zuds_tpu.archive',
}


def __getattr__(name):
    import importlib
    if name in _LAZY_MODULES:
        mod = importlib.import_module(_LAZY_MODULES[name])
        globals()[name] = mod
        return mod
    if name in _LAZY_SYMBOLS:
        mod = importlib.import_module(_LAZY_SYMBOLS[name])
        val = getattr(mod, name)
        globals()[name] = val
        return val
    raise AttributeError(f'module zuds_tpu has no attribute {name!r}')


def __dir__():
    return sorted(set(globals()) | set(_LAZY_MODULES) | set(_LAZY_SYMBOLS))
