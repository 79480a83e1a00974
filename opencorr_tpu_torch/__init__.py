"""opencorr_tpu_torch -- the PyTorch/CUDA port of the opencorr_tpu DIC engine.

Same modules, set_images / prepare / compute API, POI table layouts, failure
codes and OpenCorr CSV schemas as the JAX package, in plain PyTorch on
tensors, with hand-written CUDA kernels (``csrc/``) where the JAX package
had Pallas kernels.  Modules and top-level functions run on ``cuda`` unless
the caller passes ``device="cpu"``; without a CUDA device they raise.

Ported so far: the flagship 2D path FFTCC2D -> ICGN2D1 -> Strain, the
DVC path FFTCC3D -> ICGN3D1 -> Strain, and the feature-seeded DVC path
SIFT3D -> FeatureAffine3D -> ICGN3D1.
"""

from .utils import precision as _precision  # noqa: F401  (pins full f32)
from .data.image import Image2D, Image3D
from .data.poi import (
    POITable2D,
    POITable3D,
    new_table_2d,
    new_table_3d,
    poi_grid_2d,
    poi_grid_3d,
    table_from_numpy,
    table_from_numpy_3d,
    table_to_numpy,
)
from .io.table import (
    load_matrix_bin_3d,
    load_table_2d,
    load_table_3d,
    save_deformation_table_2d,
    save_map_2d,
    save_map_3d,
    save_matrix_bin_3d,
    save_table_2d,
    save_table_3d,
)
from .models.feature_affine import FeatureAffine3D, RansacConfig
from .models.fftcc import FFTCC2D, FFTCC3D
from .models.icgn import ICGN2D1, ICGN2D2, ICGN3D1
from .models.sift3d import SIFT3D, Sift3dConfig
from .models.strain import Strain
from .utils.precision import resolve_device

__all__ = [
    "Image2D",
    "Image3D",
    "POITable2D",
    "POITable3D",
    "new_table_2d",
    "new_table_3d",
    "poi_grid_2d",
    "poi_grid_3d",
    "table_from_numpy",
    "table_from_numpy_3d",
    "table_to_numpy",
    "load_matrix_bin_3d",
    "load_table_2d",
    "load_table_3d",
    "save_deformation_table_2d",
    "save_map_2d",
    "save_map_3d",
    "save_matrix_bin_3d",
    "save_table_2d",
    "save_table_3d",
    "FFTCC2D",
    "FFTCC3D",
    "ICGN2D1",
    "ICGN2D2",
    "ICGN3D1",
    "FeatureAffine3D",
    "RansacConfig",
    "SIFT3D",
    "Sift3dConfig",
    "Strain",
    "resolve_device",
]

__version__ = "0.1.0"
