"""SIFT-feature-based speckle pattern quality assessment.

The reference ships synthetic speckle patterns with ``*_Evaluation.csv``
files whose columns (keypoint counts, match counts, density, evenness, DEF)
support its pattern-quality workflow
(examples/speckle_pattern_quality_assessment/); no program is committed.
This utility computes those metrics for an image pair:

* kp_ref / kp_tar -- keypoints OpenCV's SIFT detects in each image
* matches -- ratio-test matched pairs (SIFT2D, on the device)
* density -- matched keypoints per pixel
* evenness -- the coefficient of variation of per-cell counts of the matched
  keypoints on a grid (lower is more even)
* mean_error (DEF) -- mean Euclidean deviation of the matches from a global
  least-squares affine fit

It needs ``cv2`` for the keypoint counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .precision import DeviceLike


@dataclasses.dataclass
class SpeckleQuality:
    kp_ref: int
    kp_tar: int
    matches: int
    density: float
    evenness: float
    mean_error: float


def assess(ref_img, tar_img, grid: int = 8,
           device: DeviceLike = None) -> SpeckleQuality:
    from ..models.sift2d import SIFT2D

    sift = SIFT2D(device=device)
    sift.set_images(ref_img, tar_img)
    sift.prepare()
    sift.compute()

    import cv2

    mat = getattr(ref_img, "mat", ref_img)
    h, w = np.asarray(mat).shape[:2]
    det = cv2.SIFT_create()
    u8 = lambda m: np.clip(np.asarray(getattr(m, "mat", m)), 0,
                           255).astype(np.uint8)
    kp_ref = len(det.detect(u8(ref_img), None))
    kp_tar = len(det.detect(u8(tar_img), None))

    mk1 = sift.ref_matched_kp
    mk2 = sift.tar_matched_kp
    n = len(mk1)
    if n < 3:
        return SpeckleQuality(kp_ref, kp_tar, n, n / (h * w), float("inf"),
                              float("inf"))

    # evenness: CV of per-cell matched-keypoint counts
    cx = np.clip((mk1[:, 0] / w * grid).astype(int), 0, grid - 1)
    cy = np.clip((mk1[:, 1] / h * grid).astype(int), 0, grid - 1)
    counts = np.bincount(cy * grid + cx, minlength=grid * grid).astype(float)
    evenness = float(counts.std() / max(counts.mean(), 1e-9))

    # DEF: residual of a global affine fit
    a = np.concatenate([mk1, np.ones((n, 1), np.float32)], axis=1)
    coef, *_ = np.linalg.lstsq(a, mk2, rcond=None)
    resid = a @ coef - mk2
    mean_error = float(np.sqrt((resid ** 2).sum(axis=1)).mean())

    return SpeckleQuality(kp_ref, kp_tar, n, n / (h * w), evenness,
                          mean_error)
