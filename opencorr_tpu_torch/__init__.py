"""opencorr_tpu_torch -- the PyTorch/CUDA port of the opencorr_tpu DIC engine.

Same modules, set_images / prepare / compute API, POI table layouts, failure
codes and OpenCorr CSV schemas as the JAX package, in plain PyTorch on
tensors, with hand-written CUDA kernels (``csrc/``) where the JAX package
had Pallas kernels.  Modules and top-level functions run on ``cuda`` unless
the caller passes ``device="cpu"``; without a CUDA device they raise.

Every module and option of the JAX package is ported but the ``parts``
benchmark knob of the SIFT3D descriptor, the XLA compile cache and
``hosthints``, which exist for the TPU: the 2D paths (FFTCC2D, ICGN2D1/2,
ICLM2D1/2, NR2D1, self-adaptive subsets, Strain, SIFT2D with its device and
OpenCV backends, FeatureAffine2D with the host or device neighbour search),
DVC (FFTCC3D, ICGN3D1 with the lattice, tile or global eval, Strain 3D),
SIFT3D (the host path by default, or the capped device path) ->
FeatureAffine3D -> ICGN3D1, stereo 3D-DIC and surface reconstruction, the
examples (``examples/``), ``utils/timing.StageTimer``, the native table
codec and multi-GPU execution on ``torch.distributed``
(``parallel.mesh``: POI batches over a mesh; ``parallel.halo.
ShardedICGN3D1``: z-sharded DVC).  As in the JAX package, the multi-GPU
layer and the examples are imported from their modules, not from here.
"""

from .utils import precision as _precision  # noqa: F401  (pins full f32)
from .data.image import ColorfulImage2D, Image2D, Image3D
from .data.poi import (
    POITable2D,
    POITable2DS,
    POITable3D,
    new_table_2d,
    new_table_2ds,
    new_table_3d,
    poi_grid_2d,
    poi_grid_3d,
    table_from_numpy,
    table_from_numpy_2ds,
    table_from_numpy_3d,
    table_to_numpy,
)
from .io.calibration_io import load_calibration, save_calibration
from .io.table import (
    load_matrix_bin_3d,
    load_points_2d,
    load_points_3d,
    load_table_2d,
    load_table_2ds,
    load_table_3d,
    save_deformation_table_2d,
    save_map_2d,
    save_map_2ds,
    save_map_3d,
    save_matrix_bin_3d,
    save_points_2d,
    save_table_2d,
    save_table_2ds,
    save_table_3d,
)
from .models.calibration import Calibration, CameraExtrinsics, CameraIntrinsics
from .models.epipolar import EpipolarSearch
from .models.feature_affine import FeatureAffine2D, FeatureAffine3D, \
    RansacConfig
from .models.fftcc import FFTCC2D, FFTCC3D
from .models.icgn import ICGN2D1, ICGN2D2, ICGN3D1
from .models.iclm import ICLM2D1, ICLM2D2
from .models.nr import NR2D1
from .models.sift2d import SIFT2D, Sift2dConfig
from .models.sift3d import SIFT3D, Sift3dConfig
from .models.stereovision import Stereovision
from .models.strain import Strain
from .utils.precision import resolve_device
from .utils.timing import StageTimer

__all__ = [
    "ColorfulImage2D",
    "Image2D",
    "Image3D",
    "POITable2D",
    "POITable2DS",
    "POITable3D",
    "new_table_2d",
    "new_table_2ds",
    "new_table_3d",
    "poi_grid_2d",
    "poi_grid_3d",
    "table_from_numpy",
    "table_from_numpy_2ds",
    "table_from_numpy_3d",
    "table_to_numpy",
    "load_calibration",
    "save_calibration",
    "load_matrix_bin_3d",
    "load_points_2d",
    "load_points_3d",
    "load_table_2d",
    "load_table_2ds",
    "load_table_3d",
    "save_deformation_table_2d",
    "save_map_2d",
    "save_map_2ds",
    "save_map_3d",
    "save_matrix_bin_3d",
    "save_points_2d",
    "save_table_2d",
    "save_table_2ds",
    "save_table_3d",
    "Calibration",
    "CameraExtrinsics",
    "CameraIntrinsics",
    "EpipolarSearch",
    "FFTCC2D",
    "FFTCC3D",
    "ICGN2D1",
    "ICGN2D2",
    "ICGN3D1",
    "ICLM2D1",
    "ICLM2D2",
    "NR2D1",
    "FeatureAffine2D",
    "FeatureAffine3D",
    "RansacConfig",
    "SIFT2D",
    "Sift2dConfig",
    "SIFT3D",
    "Sift3dConfig",
    "Stereovision",
    "Strain",
    "resolve_device",
    "StageTimer",
]

__version__ = "0.1.0"
