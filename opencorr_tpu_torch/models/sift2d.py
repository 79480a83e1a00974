"""2D SIFT feature extraction and matching (reference API: ``SIFT2D``,
oc_sift.h:39).

The reference wraps OpenCV's CPU SIFT and matches with FLANN's approximate
2-NN and Lowe's ratio test (oc_sift.cpp:60-130).  Here detection and
description run on the device (ops/sift2d.py, the JAX package's re-
implementation of OpenCV's SIFT), and matching is one distance matmul with
an exact top-2.  ``compute`` reads the matched keypoints back to the host
once.  ``backend="opencv"`` (or ``OPENCORR_SIFT2D=opencv`` when no backend
is given, as in the JAX package) detects with OpenCV's CPU SIFT, the
reference's own detector, and matches on the device as above; it needs
``cv2`` and raises ImportError where that is missing, with no fallback.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from ..ops import sift2d as sift_ops
from ..utils import timing
from ..utils.precision import DeviceLike, resolve_device
from . import base


@dataclasses.dataclass
class Sift2dConfig:
    """Defaults per oc_sift.cpp:22-30 (OpenCV defaults)."""

    n_features: int = 0
    n_octave_layers: int = 3
    contrast_threshold: float = 0.04
    edge_threshold: float = 10.0
    sigma: float = 1.6


# descriptor counts of the retain-best path are padded to a multiple of this
_PAD = 2048


class SIFT2D:
    """``backend``: ``"opencv"`` detects with ``cv2.SIFT_create``; any
    other value the device detector (the default, as the JAX package's
    ``"tpu"``); None reads ``OPENCORR_SIFT2D``.  ``octave_stats`` lists,
    per image and octave, the device detector's candidate count beside its
    cap ``k_raw`` and the refined keypoints and orientation instances
    beside ``k_kp``; a count past its cap grows the octave's buffers, so
    every keypoint is kept and matched from.  ``stats`` counts, over every
    compute, the keypoint instances matched from (``keypoints``), the
    matches (``matches``) and the caps passed (``cap_hits``: an octave's
    candidates past ``k_raw``, its keypoints or orientation instances past
    ``k_kp``); ``compute`` runs in the span
    ``sift2d.compute``, each image's detection in ``sift2d.detect`` and
    the matching in ``sift2d.match``."""

    layer = sift_ops.LAYER

    def __init__(self, backend: Optional[str] = None,
                 device: DeviceLike = None):
        self.backend = backend or os.environ.get("OPENCORR_SIFT2D",
                                                 "device")
        self.device = resolve_device(device)
        self.sift_config = Sift2dConfig()
        self.matching_ratio = 0.8  # oc_sift.cpp:29
        self.ref_img: Optional[torch.Tensor] = None
        self.tar_img: Optional[torch.Tensor] = None
        self.ref_matched_kp: Optional[np.ndarray] = None  # [K, 2] (x, y)
        self.tar_matched_kp: Optional[np.ndarray] = None
        self.octave_stats: List[dict] = []
        self.stats = collections.Counter()

    def set_sift_config(self, config: Sift2dConfig) -> None:
        self.sift_config = config

    def set_matching(self, ratio: float) -> None:
        self.matching_ratio = float(ratio)

    def set_images(self, ref_img, tar_img) -> None:
        self.ref_img = base.upload(ref_img, self.device)
        self.tar_img = base.upload(tar_img, self.device)

    def prepare(self) -> None:
        pass

    def _detect(self, img, which: str):
        cfg = self.sift_config
        with timing.span(f"{self.layer}.detect"):
            res, counts = sift_ops.detect_and_compute(
                img, n_octave_layers=cfg.n_octave_layers,
                contrast_threshold=cfg.contrast_threshold,
                edge_threshold=cfg.edge_threshold, sigma=cfg.sigma)
        self.octave_stats += [dict(image=which, **c) for c in counts]
        self.stats["cap_hits"] += sum(
            (c["candidates"] > c["k_raw"]) + (c["keypoints"] > c["k_kp"])
            + (c["instances"] > c["k_kp"]) for c in counts)
        return res, sum(c["instances"] for c in counts)

    def compute_device(self):
        """Detection, compaction and exact matching on the device, with no
        transfer to the host: (keep [K], idx [K], rx, ry, tx, ty)."""
        def compact(img, which):
            res, found = self._detect(img, which)
            self.stats["keypoints"] += found
            # every instance, in whole blocks of 2,048
            k_total = -(-max(found, 1) // 2048) * 2048
            return sift_ops.compact_octaves(res, k_total)

        rx, ry, rdesc, rok = compact(self.ref_img, "ref")
        tx, ty, tdesc, tok = compact(self.tar_img, "tar")
        with timing.span(f"{self.layer}.match"):
            keep, idx = sift_ops.match_device(rdesc, rok, tdesc, tok,
                                              self.matching_ratio)
        return keep, idx, rx, ry, tx, ty

    def compute(self) -> None:
        self.octave_stats = []
        with timing.computing(self.layer, self.stats):
            self._compute()
            self.stats["matches"] += len(self.ref_matched_kp)

    def _compute(self) -> None:
        cfg = self.sift_config
        if self.backend == "opencv":
            self._compute_opencv()
            return
        if cfg.n_features > 0:
            # retainBest sorts responses on the host
            rp, rd, _, _, rr = sift_ops.gather_keypoints(
                self._detect(self.ref_img, "ref")[0])
            tp, td, _, _, tr = sift_ops.gather_keypoints(
                self._detect(self.tar_img, "tar")[0])
            rp, rd = _retain_best(rp, rd, rr, cfg.n_features)
            tp, td = _retain_best(tp, td, tr, cfg.n_features)
            self.stats["keypoints"] += len(rp) + len(tp)
            keep, idx = self._match_host(rd, td)
            self.ref_matched_kp = rp[keep]
            self.tar_matched_kp = tp[idx[keep]]
            return
        keep, idx, rx, ry, tx, ty = self.compute_device()
        keep = self._read("keep", keep)
        idx = self._read("idx", idx)
        rxy = self._read("ref_xy", torch.stack([rx, ry], -1))
        txy = self._read("tar_xy", torch.stack([tx, ty], -1))
        self.ref_matched_kp = rxy[keep]
        self.tar_matched_kp = txy[idx[keep]]

    def _compute_opencv(self) -> None:
        """OpenCV's SIFT with the config on the 8-bit images (values
        clipped to [0, 255]), then the exact device match."""
        try:
            import cv2
        except ImportError as e:
            raise ImportError("SIFT2D(backend='opencv') needs cv2 "
                              "(OpenCV), which is not installed") from e
        cfg = self.sift_config
        sift = cv2.SIFT_create(
            nfeatures=cfg.n_features, nOctaveLayers=cfg.n_octave_layers,
            contrastThreshold=cfg.contrast_threshold,
            edgeThreshold=cfg.edge_threshold, sigma=cfg.sigma)
        found = []
        for img in (self.ref_img, self.tar_img):
            u8 = self._read("image", img.clamp(0, 255).to(torch.uint8))
            kp, desc = sift.detectAndCompute(u8, None)
            found.append((np.array([k.pt for k in kp], np.float32)
                          .reshape(-1, 2), desc))
        (ref_pts, ref_desc), (tar_pts, tar_desc) = found
        self.stats["keypoints"] += len(ref_pts) + len(tar_pts)
        if ref_desc is None or tar_desc is None or len(ref_pts) == 0 \
                or len(tar_pts) < 2:
            self.ref_matched_kp = np.zeros((0, 2), np.float32)
            self.tar_matched_kp = np.zeros((0, 2), np.float32)
            return
        keep, idx = self._match_host(ref_desc, tar_desc)
        self.ref_matched_kp = ref_pts[keep]
        self.tar_matched_kp = tar_pts[idx[keep]]

    def _match_host(self, ref_desc, tar_desc):
        """Exact matching of host descriptor arrays, padded to a multiple
        of ``_PAD`` rows."""
        n_ref, n_tar = len(ref_desc), len(tar_desc)
        pad = lambda a, n: torch.from_numpy(np.pad(
            np.asarray(a, np.float32), ((0, -n % _PAD), (0, 0)))).to(
                self.device)
        r, t = pad(ref_desc, n_ref), pad(tar_desc, n_tar)
        r_ok = torch.arange(r.shape[0], device=self.device) < n_ref
        t_ok = torch.arange(t.shape[0], device=self.device) < n_tar
        with timing.span(f"{self.layer}.match"):
            keep, idx = sift_ops.match_device(r, r_ok, t, t_ok,
                                              self.matching_ratio)
        return self._read("keep", keep)[:n_ref], self._read("idx", idx)[:n_ref]

    def _read(self, what: str, value: torch.Tensor) -> np.ndarray:
        """The host copy of ``value``, read as ``sift2d.sync.<what>``."""
        return timing.host_read(f"{self.layer}.sync.{what}", value)

    def clear(self) -> None:
        self.ref_matched_kp = None
        self.tar_matched_kp = None


def _retain_best(pts, desc, resp, n):
    """cv::KeyPointsFilter::retainBest: keep the n strongest responses."""
    if len(pts) <= n:
        return pts, desc
    order = np.argsort(-resp, kind="stable")[:n]
    return pts[order], desc[order]
