"""Image and volume ingestion (mirrors ``Image2D``, ``Image3D`` and
``ColorfulImage2D``, oc_image.h:28-68).

The voxels stay a host float32 array; modules upload them to their device
in ``set_images``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Image2D:
    """Grayscale 2D image as float32 [H, W]."""

    mat: np.ndarray  # [H, W] f32
    file_path: str = ""

    @property
    def height(self) -> int:
        return self.mat.shape[0]

    @property
    def width(self) -> int:
        return self.mat.shape[1]

    @classmethod
    def load(cls, file_path: str) -> "Image2D":
        """Any format OpenCV reads, converted to grayscale like
        ``cv::imread(path, IMREAD_GRAYSCALE)`` (oc_image.cpp:37-57)."""
        import cv2

        m = cv2.imread(file_path, cv2.IMREAD_GRAYSCALE)
        if m is None:
            raise IOError(f"Fail to load file: {file_path}")
        return cls(mat=m.astype(np.float32), file_path=file_path)

    @classmethod
    def from_array(cls, arr) -> "Image2D":
        return cls(mat=np.asarray(arr, np.float32))


@dataclasses.dataclass
class Image3D:
    """Volume image as float32 [dim_z, dim_y, dim_x] (mirrors ``Image3D``,
    oc_image.h:46).

    Files: the OpenCorr ``.bin`` format, an ``int32[3]`` header (dim_x,
    dim_y, dim_z) followed by the float32 [dim_z, dim_y, dim_x] payload
    (oc_image.cpp:76-110), or a multi-page TIFF (oc_image.cpp:112-145)."""

    mat: np.ndarray  # [Z, Y, X] f32
    file_path: str = ""

    @property
    def dim_x(self) -> int:
        return self.mat.shape[2]

    @property
    def dim_y(self) -> int:
        return self.mat.shape[1]

    @property
    def dim_z(self) -> int:
        return self.mat.shape[0]

    @classmethod
    def load(cls, file_path: str) -> "Image3D":
        ext = file_path.rsplit(".", 1)[-1].lower()
        if ext == "bin":
            return cls.load_bin(file_path)
        if ext in ("tif", "tiff"):
            return cls.load_tiff(file_path)
        raise IOError("Not binary file or multi-page tiff: " + file_path)

    @classmethod
    def load_bin(cls, file_path: str) -> "Image3D":
        with open(file_path, "rb") as f:
            dims = np.fromfile(f, dtype=np.int32, count=3)
            dim_x, dim_y, dim_z = (int(d) for d in dims)
            data = np.fromfile(f, dtype=np.float32,
                               count=dim_x * dim_y * dim_z)
        return cls(mat=data.reshape(dim_z, dim_y, dim_x), file_path=file_path)

    @classmethod
    def load_tiff(cls, file_path: str) -> "Image3D":
        import cv2

        ok, pages = cv2.imreadmulti(file_path, flags=cv2.IMREAD_GRAYSCALE)
        if not ok or not pages:
            raise IOError("Fail to load multi-page tiff: " + file_path)
        vol = np.stack([p.astype(np.float32) for p in pages], axis=0)
        return cls(mat=vol, file_path=file_path)

    def save_bin(self, file_path: str) -> None:
        with open(file_path, "wb") as f:
            np.array([self.dim_x, self.dim_y, self.dim_z], np.int32).tofile(f)
            self.mat.astype(np.float32).tofile(f)

    @classmethod
    def from_array(cls, arr) -> "Image3D":
        return cls(mat=np.asarray(arr, np.float32))


@dataclasses.dataclass
class ColorfulImage2D:
    """A colour image as float32 [H, W] planes b, g and r (mirrors
    ``ColorfulImage2D``, oc_image.h:68 / oc_image.cpp:177-223)."""

    b: np.ndarray
    g: np.ndarray
    r: np.ndarray
    file_path: str = ""

    @property
    def height(self) -> int:
        return self.b.shape[0]

    @property
    def width(self) -> int:
        return self.b.shape[1]

    @classmethod
    def load(cls, file_path: str) -> "ColorfulImage2D":
        """Any format OpenCV reads, as ``cv::imread(path, IMREAD_COLOR)``
        split into its blue, green and red planes."""
        import cv2

        m = cv2.imread(file_path, cv2.IMREAD_COLOR)
        if m is None:
            raise IOError(f"Fail to load file: {file_path}")
        b, g, r = cv2.split(m)
        return cls(b=b.astype(np.float32), g=g.astype(np.float32),
                   r=r.astype(np.float32), file_path=file_path)
