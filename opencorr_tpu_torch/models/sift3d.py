"""The 3D SIFT module (reference API: ``SIFT3D``, oc_sift.h:135).

Builds the Gaussian and DoG pyramids one octave at a time on the module's
device, extracts and orients the extrema of every layer, describes the
survivors (the fused histogram, kernel 4, on layers whose crop fits; the
exact einsum path on the small top layers), merges every layer into one
keypoint table and matches the two volumes' tables with a 2-NN search and
the reference's elimination (monodirectionalMatch / bidirectionalMatch,
oc_sift.cpp:1251-1489).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ..ops import sift3d as ops3d
from ..utils.precision import DeviceLike, resolve_device
from .base import upload

# The JAX package assembles at most this many keypoints per volume.
KP_CAP = 65536


@dataclasses.dataclass
class Sift3dConfig:
    """Defaults per oc_sift.cpp:142-159."""

    n_octave_layers: int = 3
    n_octave: int = 0  # derived in createGaussianPyramid
    min_dimension: int = 8
    alpha: float = 0.1
    beta: float = 0.9
    gamma: float = 0.4
    sigma_source: float = 1.15
    sigma_base: float = 1.6
    gradient_threshold: float = 1e-10
    truncate_threshold: float = 0.2 * 128 / 768


@dataclasses.dataclass
class _Layer:
    dims: tuple  # (z, y, x)
    units: tuple  # (ux, uy, uz)
    octave: int
    scale: float
    sigma: float = 0.0


def _bucket8(r: int) -> int:
    return ((r + 7) // 8) * 8


class SIFT3D:
    """3D SIFT feature matching between a reference and a target volume.

    ``pyramid_backend`` is ``"device"`` (the default): the pyramid, the
    extrema and everything after them run on the module's device.  The JAX
    package defaults to ``"host"`` because each pyramid-layer shape costs it
    one jit compilation; eager PyTorch compiles nothing, so that reason does
    not hold here, and the host path is not ported.  ``hist_bf16`` (the JAX
    package's bf16 histogram option) is not ported either.

    ``match_mode``: ``"mono"`` (the reference default: monodirectional with
    many-to-one elimination) or ``"bi"`` (mutual best matches).

    After ``compute``: ``ref_matched_kp`` and ``tar_matched_kp`` ([M, 3]
    x, y, z), ``ref_kp_count``/``tar_kp_count``, and ``layer_stats``, one
    record per (volume, octave, layer) with its candidate count before the
    cap k_e, its oriented survivors and the descriptor cap k_d."""

    def __init__(self, pyramid_backend: str = "device",
                 match_mode: str = "mono", hist_bf16: bool = False,
                 device: DeviceLike = None):
        if pyramid_backend != "device":
            raise NotImplementedError(
                f"SIFT3D: pyramid_backend={pyramid_backend!r} is not ported; "
                "the port builds the pyramid on its device ('device')")
        if hist_bf16:
            raise NotImplementedError(
                "SIFT3D: hist_bf16 is not ported (float32 histograms only)")
        if match_mode not in ("mono", "bi"):
            raise ValueError(f"match_mode {match_mode!r}")
        self.device = resolve_device(device)
        self.match_mode = match_mode
        self.sift_config = Sift3dConfig()
        self.matching_ratio = 0.85  # oc_sift.cpp:153
        self.physical_unit = (1.0, 1.0, 1.0)
        self.ref_img = None
        self.tar_img = None
        self.ref_matched_kp: Optional[np.ndarray] = None
        self.tar_matched_kp: Optional[np.ndarray] = None
        self.ref_kp_count = 0
        self.tar_kp_count = 0
        self.layer_stats: List[dict] = []

    def set_sift_config(self, cfg: Sift3dConfig):
        self.sift_config = cfg

    def set_physical_unit(self, ux: float, uy: float, uz: float):
        self.physical_unit = (float(ux), float(uy), float(uz))

    def set_matching_ratio(self, ratio: float):
        self.matching_ratio = float(ratio)

    def set_images(self, ref_img, tar_img):
        self.ref_img = ref_img
        self.tar_img = tar_img

    def prepare(self):
        pass

    def clear(self):
        self.ref_matched_kp = None
        self.tar_matched_kp = None

    # ------------------------------------------------------------------
    def _plan_layers(self, vol_shape) -> List[_Layer]:
        """Layer schedule (dims, units, scale, sigma) of
        createGaussianPyramid (oc_sift.cpp:676-754)."""
        cfg = self.sift_config
        dz, dy, dx = vol_shape
        dim_min = min(dx, dy, dz)
        cfg.n_octave = max(
            int(math.floor(math.log2(dim_min) - math.log2(cfg.min_dimension)))
            + 1, 1)
        lpo = cfg.n_octave_layers + 3
        kappa = 2.0 ** (1.0 / cfg.n_octave_layers)

        layers: List[_Layer] = []
        x_len, y_len, z_len = dx, dy, dz
        ux, uy, uz = self.physical_unit
        scale0 = cfg.sigma_base / kappa
        sigma0 = math.sqrt(max(scale0 * scale0 - cfg.sigma_source ** 2, 0.0))
        layers.append(_Layer((z_len, y_len, x_len), (ux, uy, uz), 0, scale0,
                             sigma0))
        for i in range(1, cfg.n_octave * lpo):
            octave = i // lpo
            lin = i % lpo
            if lin == 0:
                x_len //= 2
                y_len //= 2
                z_len //= 2
                ux *= 2
                uy *= 2
                uz *= 2
                scale = layers[(octave - 1) * lpo + cfg.n_octave_layers].scale
                sigma = 0.0
            else:
                scale = kappa * layers[i - 1].scale
                # NOTE: indexes the FIRST octave's layer (oc_sift.cpp:728)
                sigma = math.sqrt(kappa * kappa - 1.0) * layers[lin - 1].scale
            layers.append(_Layer((z_len, y_len, x_len), (ux, uy, uz), octave,
                                 scale, sigma))
        return layers

    def _layer_params(self, g: _Layer, n: int):
        """(n, k_e, r_orient, k_d, r_desc, scale) of one extraction layer:
        the candidate cap k_e (voxels / 1024 in [256, 65536], a power of
        two), the descriptor cap k_d = k_e / 2 (at least 256) and the
        window radii, bucketed to multiples of 8 and capped by the layer."""
        voxels = int(np.prod(g.dims))
        k_e = int(np.clip(voxels // 1024, 256, 65536))
        k_e = 1 << (k_e - 1).bit_length()
        scale = g.scale
        r_cap = (min(g.dims) - 1) // 2
        r_orient = min(_bucket8(
            int(math.ceil(3.0 * 1.5 * scale / g.units[0])) + 1), r_cap)
        sphere = 2.0 * 5.0 * math.sqrt(2.0) * scale
        r_desc = min(_bucket8(int(math.ceil(sphere / g.units[0])) + 1), r_cap)
        k_d = max(k_e // 2, 256)
        return (n, k_e, r_orient, k_d, r_desc, scale)

    def _extract_device(self, vol: torch.Tensor, tag: str = ""):
        """Feature extraction of one volume, octave by octave (only one
        octave's Gaussian and DoG stacks live at a time).  Returns (kp
        [K, 6] (x, y, z, octave, layer, scale), desc [K, 768]) on the
        device, at most KP_CAP rows, in layer order then scan order."""
        cfg = self.sift_config
        layers = self._plan_layers(vol.shape)
        lpo_g = cfg.n_octave_layers + 3
        staged = []
        seed = vol
        for m in range(cfg.n_octave):
            base = m * lpo_g
            if m == 0:
                sigmas = tuple(layers[base + n].sigma for n in range(lpo_g))
                down = None
            else:
                sigmas = (None,) + tuple(
                    layers[base + n].sigma for n in range(1, lpo_g))
                down = layers[base].dims
            lp = [self._layer_params(layers[base + n], n)
                  for n in range(1, cfg.n_octave_layers + 1)]
            seed, outs = ops3d.octave_features(
                seed, cfg, sigmas=sigmas, unit_xyz=layers[base].units,
                downsample_to=down, layer_params=lp,
                seed_layer=cfg.n_octave_layers)
            for par, (xd, yd, zd, desc, st) in zip(lp, outs):
                staged.append((xd, yd, zd, desc, m, par[0], par[5], par[3]))
                self.layer_stats.append(dict(volume=tag, octave=m, **st))

        k_tot = sum(s[7] for s in staged)
        k_cap = min(1 << (k_tot - 1).bit_length(), KP_CAP)
        kp, desc, ok = ops3d.assemble_keypoints(
            [s[0] for s in staged], [s[1] for s in staged],
            [s[2] for s in staged],
            [torch.ones(s[0].shape[0], dtype=torch.bool, device=vol.device)
             for s in staged],
            [s[3] for s in staged],
            [(2.0 ** s[4], s[4], s[5], s[6]) for s in staged], k_cap=k_cap)
        n = min(sum(s[0].shape[0] for s in staged), k_cap)
        return kp[:n], desc[:n]

    # ------------------------------------------------------------------
    def compute(self):
        self.layer_stats = []
        kp1d, desc1 = self._extract_device(upload(self.ref_img, self.device),
                                           "ref")
        kp2d, desc2 = self._extract_device(upload(self.tar_img, self.device),
                                           "tar")
        n1, n2 = kp1d.shape[0], kp2d.shape[0]
        self.ref_kp_count, self.tar_kp_count = n1, n2
        kp1, kp2 = kp1d.cpu().numpy(), kp2d.cpu().numpy()
        ratio = self.matching_ratio
        empty = np.zeros((0, 3), np.float32)
        if self.match_mode == "bi":
            if n1 < 2 or n2 < 2:
                mk1, mk2 = empty, empty
            else:
                ok1 = torch.ones(n1, dtype=torch.bool, device=self.device)
                ok2 = torch.ones(n2, dtype=torch.bool, device=self.device)
                d12, i12 = ops3d.match_top2(desc1, desc2, ok2)
                d21, i21 = ops3d.match_top2(desc2, desc1, ok1)
                mk1, mk2 = _bi_eliminate(
                    kp1, np.ones(n1, bool), kp2, np.ones(n2, bool),
                    d12.cpu().numpy(), i12.cpu().numpy(), d21.cpu().numpy(),
                    i21.cpu().numpy(), ratio)
        elif n1 == 0 or n2 < 2:
            mk1, mk2 = empty, empty
        else:
            ok2 = torch.ones(n2, dtype=torch.bool, device=self.device)
            d12, i12 = ops3d.match_top2(desc1, desc2, ok2)
            mk1, mk2 = _mono_eliminate(
                kp1, np.ones(n1, bool), kp2, n2, d12.cpu().numpy(),
                i12.cpu().numpy(), ratio)
        self.ref_matched_kp = mk1
        self.tar_matched_kp = mk2


def _mono_eliminate(kp1, valid1, kp2, n2_valid, d2, idx2, ratio):
    """Host tail of the monodirectional match given 2-NN tables: ratio test
    and many-to-one elimination (oc_sift.cpp:1251-1418).  ``valid1`` masks
    rows of kp1; ``n2_valid`` guards the fewer-than-2-targets case."""
    if not valid1.any() or n2_valid < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    ratio2 = ratio * ratio
    keep = valid1 & (d2[:, 0] < ratio2 * d2[:, 1])
    ref_idx = np.nonzero(keep)[0]
    tar_idx = idx2[keep, 0]
    dist = d2[keep, 0]

    # many-to-one elimination: for each target matched by several refs, run
    # the ratio test among those refs' distances; keep the best only if
    # distinct.
    order = np.argsort(tar_idx, kind="stable")
    ref_idx, tar_idx, dist = ref_idx[order], tar_idx[order], dist[order]
    keep_final = np.ones(len(ref_idx), bool)
    start = 0
    while start < len(tar_idx):
        end = start
        while end + 1 < len(tar_idx) and tar_idx[end + 1] == tar_idx[start]:
            end += 1
        if end > start:
            seg = slice(start, end + 1)
            dists = dist[seg]
            o = np.argsort(dists)
            keep_final[seg] = False
            if len(dists) >= 2 and dists[o[0]] < ratio2 * dists[o[1]]:
                keep_final[start + o[0]] = True
        start = end + 1

    ref_idx = ref_idx[keep_final]
    tar_idx = tar_idx[keep_final]
    return kp1[ref_idx, :3].copy(), kp2[tar_idx, :3].copy()


def _bi_eliminate(kp1, valid1, kp2, valid2, d12, i12, d21, i21, ratio):
    """Host tail of the bidirectional match (oc_sift.cpp:1420-1489): keep
    only pairs that are each other's ratio-test best match."""
    if valid1.sum() < 2 or valid2.sum() < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    ratio2 = ratio * ratio
    r2t = np.where(valid1 & (d12[:, 0] < ratio2 * d12[:, 1]), i12[:, 0], -1)
    t2r = np.where(valid2 & (d21[:, 0] < ratio2 * d21[:, 1]), i21[:, 0], -1)
    keep = (r2t >= 0) & (t2r[np.clip(r2t, 0, None)] == np.arange(len(kp1)))
    ref_idx = np.nonzero(keep)[0]
    return kp1[ref_idx, :3].copy(), kp2[r2t[ref_idx], :3].copy()
