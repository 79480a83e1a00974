"""The 3D SIFT module (reference API: ``SIFT3D``, oc_sift.h:135).

Two ways through, as in the JAX package (``pyramid_backend``):

* ``"host"`` (the default): the JAX package's host path, with its scipy
  mirror blur reproduced exactly (:func:`_host_gaussian_blur`, a float64
  pass on the module's device), every extremum of every layer (no caps),
  orientation on windows of bucket-8 radius gathered on the device from
  the layer (``ops3d.orient_keypoints``), descriptors through the fused
  histogram (kernel 4) on layers whose crop fits and whose window holds
  the descriptor sphere, the exact einsum path elsewhere
  (``ops3d.describe_keypoints``), and an unchunked 2-NN match
  (:func:`_top2_distances`).
* ``"device"``: the capped device path, one octave at a time: extrema
  compacted up to the cap k_e, orientation, survivors up to k_d,
  descriptors, and one keypoint table of at most ``KP_CAP`` rows, matched
  in chunks.

Any other value runs the host path's structure with the device blur and
extremum test (as the JAX package does).  Matching is the reference's
monodirectional (many-to-one elimination) or bidirectional rule
(oc_sift.cpp:1251-1489).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..ops import desc3d
from ..ops import sift3d as ops3d
from ..utils.precision import DeviceLike, f32, resolve_device
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

    ``pyramid_backend``: ``"host"`` (the default, the JAX package's host
    path: every extremum kept) or ``"device"`` (the capped device path);
    see the module docstring.  ``kp_chunk_budget_bytes`` is kept for the
    JAX package's signature and changes nothing: the port sizes its
    keypoint chunks from the device's memory (``ops3d.work_budget``), and
    chunking changes no keypoint's result.  ``match_mode``:
    ``"mono"`` (the reference default: monodirectional with many-to-one
    elimination) or ``"bi"`` (mutual best matches).  ``hist_bf16`` rounds
    the descriptor histogram's operands to bfloat16 on the device path;
    the host path's descriptors are float32 whatever it says, as in the
    JAX package (its host path never passes the option on).

    After ``compute``: ``ref_matched_kp`` and ``tar_matched_kp`` ([M, 3]
    x, y, z), ``ref_kp_count``/``tar_kp_count``, ``layer_stats`` (one
    record per volume, octave and layer: the candidates, oriented
    survivors and kept keypoints, the device path's caps k_e and k_d, the
    descriptor crop and which descriptor ran) and, on the host path,
    ``stage_ms`` (wall ms of each host-path stage, both volumes,
    synchronised at the stage boundaries, the window gathers counted with
    orientation and descriptors)."""

    def __init__(self, kp_chunk_budget_bytes: int = 1 << 30,
                 pyramid_backend: str = "host", match_mode: str = "mono",
                 hist_bf16: bool = False, device: DeviceLike = None):
        if match_mode not in ("mono", "bi"):
            raise ValueError(f"match_mode {match_mode!r}")
        self.device = resolve_device(device)
        self.kp_chunk_budget = int(kp_chunk_budget_bytes)
        self.pyramid_backend = pyramid_backend
        self.match_mode = match_mode
        self.hist_bf16 = bool(hist_bf16)
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
        self.stage_ms: dict = {}

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

    @staticmethod
    def _radii(g: _Layer):
        """(r_orient, r_desc) of a layer: the orientation and descriptor
        windows' radii, with a voxel of margin for the gradient stencil,
        bucketed to multiples of 8 and capped by the layer (voxel radii do
        not change with the octave: scale and pitch both double)."""
        r_cap = (min(g.dims) - 1) // 2
        r_orient = min(_bucket8(
            int(math.ceil(3.0 * 1.5 * g.scale / g.units[0])) + 1), r_cap)
        sphere = 2.0 * 5.0 * math.sqrt(2.0) * g.scale
        r_desc = min(_bucket8(int(math.ceil(sphere / g.units[0])) + 1),
                     r_cap)
        return r_orient, r_desc

    def _layer_params(self, g: _Layer, n: int):
        """(n, k_e, r_orient, k_d, r_desc, scale) of one extraction layer
        of the device path: the candidate cap k_e (voxels / 1024 in
        [256, 65536], a power of two) and the descriptor cap k_d = k_e / 2
        (at least 256)."""
        voxels = int(np.prod(g.dims))
        k_e = int(np.clip(voxels // 1024, 256, 65536))
        k_e = 1 << (k_e - 1).bit_length()
        r_orient, r_desc = self._radii(g)
        k_d = max(k_e // 2, 256)
        return (n, k_e, r_orient, k_d, r_desc, g.scale)

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
                seed_layer=cfg.n_octave_layers, hist_bf16=self.hist_bf16)
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

    # --- the host path -----------------------------------------------------
    def _stage(self, name: str, t0: float) -> float:
        """Add the wall time since ``t0`` to ``stage_ms[name]`` once the
        device has finished; returns the new start."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.stage_ms[name] = self.stage_ms.get(name, 0.0) + (t1 - t0) * 1e3
        return t1

    def _gaussian_pyramid(self, vol: torch.Tensor):
        """createGaussianPyramid (oc_sift.cpp:676-754): (layers, volumes),
        the host path's blur or the device blur by ``pyramid_backend``."""
        cfg = self.sift_config
        layers = self._plan_layers(vol.shape)
        lpo = cfg.n_octave_layers + 3
        blur = (_host_gaussian_blur if self.pyramid_backend == "host"
                else ops3d.gaussian_blur)
        vols = [blur(vol, layers[0].sigma, layers[0].units)]
        for i in range(1, len(layers)):
            if i % lpo == 0:
                vols.append(ops3d.downsample(vols[i - 3], layers[i].dims))
            else:
                vols.append(blur(vols[i - 1], layers[i].sigma,
                                 layers[i].units))
        return layers, vols

    def _dog_pyramid(self, vols):
        """The DoG layers and their max |DoG| (as Python floats)."""
        cfg = self.sift_config
        lpo_g = cfg.n_octave_layers + 3
        dogs = []
        for m in range(cfg.n_octave):
            for n in range(cfg.n_octave_layers + 2):
                i = m * lpo_g + n
                d, max_abs = ops3d.dog_layer(vols[i + 1], vols[i])
                dogs.append((d, float(max_abs)))
        return dogs

    def _extract(self, vol: torch.Tensor, tag: str = ""):
        """Feature extraction of one volume on the host path's structure:
        every extremum of every layer, its orientation and, for the
        oriented ones, the descriptor, layer by layer.  Returns (kp [K, 6]
        (x, y, z, octave, layer, scale) and desc [K, 768]) on the device,
        in layer order then scan order."""
        cfg = self.sift_config
        host = self.pyramid_backend == "host"
        dev = vol.device
        t0 = time.perf_counter()
        layers, gp = self._gaussian_pyramid(vol)
        t0 = self._stage("blur", t0)
        dogs = self._dog_pyramid(gp)
        t0 = self._stage("dog", t0)
        lpo_g = cfg.n_octave_layers + 3
        lpo_d = cfg.n_octave_layers + 2
        groups = []  # (m, n, x, y, z)
        for m in range(cfg.n_octave):
            for n in range(1, cfg.n_octave_layers + 1):
                li = m * lpo_d + n
                (dp, _), (dc, mc), (dn, _) = dogs[li - 1], dogs[li], \
                    dogs[li + 1]
                if host:
                    mask = _host_extrema_mask(dp, dc, dn, cfg.alpha * mc)
                else:
                    mask = ops3d.extrema_mask(dp, dc, dn,
                                              f32(cfg.alpha) * f32(mc))
                zz, yy, xx = torch.nonzero(mask, as_tuple=True)
                groups.append((m, n, xx, yy, zz))
        del dogs
        t0 = self._stage("extrema", t0)

        kps, descs = [], []
        for m, n, x, y, z in groups:
            g, vg = layers[m * lpo_g + n], gp[m * lpo_g + n]
            st = dict(volume=tag, octave=m, layer=n, dims=list(vg.shape),
                      candidates=int(x.numel()))
            self.layer_stats.append(st)
            if not x.numel():
                st.update(oriented=0, kept=0)
                continue
            r_orient, _ = self._radii(g)
            t0 = time.perf_counter()
            rot, ok = ops3d.orient_keypoints(
                vg, x, y, z, g.scale, g.units, cfg.gradient_threshold,
                cfg.beta, cfg.gamma, r=r_orient)
            self._stage("orientation", t0)
            x, y, z, rot = x[ok], y[ok], z[ok], rot[ok]
            st.update(oriented=int(x.numel()), kept=int(x.numel()))
            if not x.numel():
                continue
            desc, crop, route = self._describe(vg, g, x, y, z, rot)
            st.update(crop=list(crop), route=route)
            f = float(2.0 ** m)
            kps.append(torch.stack(
                [x.float() * f, y.float() * f, z.float() * f,
                 torch.full_like(x, m, dtype=torch.float32),
                 torch.full_like(x, n, dtype=torch.float32),
                 torch.full_like(x, f32(g.scale), dtype=torch.float32)], 1))
            descs.append(desc)
        if not kps:
            return (torch.zeros((0, 6), device=dev),
                    torch.zeros((0, 768), device=dev))
        return torch.cat(kps), torch.cat(descs)

    def _describe(self, vg: torch.Tensor, g: _Layer, x, y, z, rot):
        """The host path's descriptors of one layer's oriented keypoints:
        (desc [K, 768], crop, route), through kernel 4 where
        :func:`_descriptor_route` allows, else the exact einsum path on
        the keypoints' windows."""
        cfg = self.sift_config
        _, r_desc = self._radii(g)
        crop = ops3d._sphere_crop(r_desc, g.scale, g.units)
        route = _descriptor_route(crop, r_desc, g, vg.shape)
        t0 = time.perf_counter()
        if route == "kernel 4":
            desc = desc3d.describe_keypoints_fused(
                vg, x, y, z, rot, cfg.truncate_threshold, crop=crop,
                scale=g.scale, unit_xyz=g.units)
        else:
            desc = ops3d.describe_keypoints(
                vg, x, y, z, rot, g.scale, g.units, cfg.truncate_threshold,
                r=r_desc, crop=crop)
        self._stage("descriptors", t0)
        return desc, crop, route

    # ------------------------------------------------------------------
    def compute(self):
        self.layer_stats = []
        self.stage_ms = {}
        ref = upload(self.ref_img, self.device)
        tar = upload(self.tar_img, self.device)
        extract = (self._extract_device if self.pyramid_backend == "device"
                   else self._extract)
        kp1, desc1 = extract(ref, "ref")
        kp2, desc2 = extract(tar, "tar")
        self._match(kp1, desc1, kp2, desc2)

    def _match(self, kp1d, desc1, kp2d, desc2):
        """Both volumes' keypoints [K, 6] and descriptors [K, 768] to
        ``ref_matched_kp``/``tar_matched_kp`` and the keypoint counts: the
        device path's chunked 2-NN search, or the host path's unchunked
        one, then the reference's elimination."""
        n1, n2 = kp1d.shape[0], kp2d.shape[0]
        self.ref_kp_count, self.tar_kp_count = n1, n2
        kp1, kp2 = kp1d.cpu().numpy(), kp2d.cpu().numpy()
        ratio = self.matching_ratio
        if self.pyramid_backend != "device":
            t0 = time.perf_counter()
            match = (_bidirectional_match if self.match_mode == "bi"
                     else _monodirectional_match)
            mk1, mk2 = match(kp1, desc1, kp2, desc2, ratio)
            self._stage("match", t0)
        elif self.match_mode == "bi" and min(n1, n2) >= 2:
            ok1 = torch.ones(n1, dtype=torch.bool, device=self.device)
            ok2 = torch.ones(n2, dtype=torch.bool, device=self.device)
            d12, i12 = ops3d.match_top2(desc1, desc2, ok2)
            d21, i21 = ops3d.match_top2(desc2, desc1, ok1)
            mk1, mk2 = _bi_eliminate(
                kp1, np.ones(n1, bool), kp2, np.ones(n2, bool),
                d12.cpu().numpy(), i12.cpu().numpy(), d21.cpu().numpy(),
                i21.cpu().numpy(), ratio)
        elif self.match_mode == "mono" and n1 > 0 and n2 >= 2:
            ok2 = torch.ones(n2, dtype=torch.bool, device=self.device)
            d12, i12 = ops3d.match_top2(desc1, desc2, ok2)
            mk1, mk2 = _mono_eliminate(
                kp1, np.ones(n1, bool), kp2, n2, d12.cpu().numpy(),
                i12.cpu().numpy(), ratio)
        else:
            mk1 = mk2 = np.zeros((0, 3), np.float32)
        self.ref_matched_kp = mk1
        self.tar_matched_kp = mk2


def _host_gaussian_blur(vol: torch.Tensor, sigma: float,
                        unit_xyz) -> torch.Tensor:
    """The JAX package's host blur, scipy's ``convolve1d(..., mode=
    "mirror")`` with the reference's taps along x, y, then z
    (oc_sift.cpp:365-548), reproduced on ``vol``'s device: scipy sums in
    float64, each pair of mirrored taps first, t0 * v plus
    t_r * (v[-r] + v[+r]) from the farthest r in, and rounds the sum to
    float32 once."""
    out = vol
    for axis, radius, taps in ops3d.blur_taps(sigma, unit_xyz):
        n = out.shape[axis]
        padded = out.index_select(axis, ops3d._reflect_index(n, radius,
                                                             out.device))
        acc = out.double() * taps[0]
        for r in range(radius, 0, -1):
            side = (padded.narrow(axis, radius - r, n).double()
                    + padded.narrow(axis, radius + r, n).double())
            acc += side.mul_(taps[r])
            del side
        del padded
        out = acc.float()
        del acc
    return out


def _host_extrema_mask(dog_prev, dog_cur, dog_next, alpha_max_abs: float):
    """The host path's extremum mask: ``ops3d.extrema_mask`` (np.roll's
    wrap-around at the faces, the 1-voxel border cleared after it) at the
    threshold the host path compares in float32, alpha * max|DoG| taken in
    float64 and then rounded, where the device path multiplies in
    float32."""
    return ops3d.extrema_mask(dog_prev, dog_cur, dog_next,
                              f32(alpha_max_abs))


def _descriptor_route(crop, r_desc: int, g: _Layer, dims) -> str:
    """Which descriptor a host-path layer takes.  Kernel 4 reads a box of
    ``crop`` radii around the keypoint (clamped into the volume); the JAX
    host path sums over the keypoint's window of radius ``r_desc``
    (clamped into the volume).  The two hold the same in-sphere voxels
    when the window holds the descriptor sphere on every axis
    (int(rad / unit) + 1 <= r_desc, so that the crop radius is that bound);
    where ``r_desc`` was capped by a small layer below it, a keypoint near
    a face sees other voxels, and the layer takes the exact einsum path.
    So does a layer whose crop plus margin does not fit."""
    if not ops3d.crop_fits(crop, dims):
        return "plain: crop does not fit"
    rad = 2.0 * 5.0 * math.sqrt(2.0) * float(g.scale)
    units = (g.units[2], g.units[1], g.units[0])  # z, y, x
    if any(int(rad / u) + 1 > r_desc for u in units):
        return "plain: window clips the sphere"
    return "kernel 4"


def _top2_distances(d1: torch.Tensor, d2: torch.Tensor):
    """The two smallest squared descriptor distances of every row of d1
    over all rows of d2, ||r||^2 + ||t||^2 - 2 r.t clamped at 0, in one
    [K1, K2] product (the JAX host path's, unchunked), with the lower index
    first among equal distances, as ``jax.lax.top_k`` orders them.
    Returns numpy (d2 [K1, 2], idx [K1, 2])."""
    rr = (d1 * d1).sum(1, keepdim=True)
    tt = (d2 * d2).sum(1)[None, :]
    dist2 = torch.mm(d1, d2.T).mul_(-2.0)  # exact: a power of two
    dist2 = (rr + tt).add_(dist2).clamp_(min=0.0)
    rows = torch.arange(d1.shape[0], device=d1.device)
    first, i0 = dist2.min(1)  # the first of equal minima
    dist2[rows, i0] = float("inf")
    second, i1 = dist2.min(1)
    del dist2
    d = torch.stack([first, second], 1).cpu().numpy()
    return d, torch.stack([i0, i1], 1).cpu().numpy()


def _monodirectional_match(kp1, desc1, kp2, desc2, ratio):
    """monodirectionalMatch (oc_sift.cpp:1251-1418): 2-NN ratio test, then
    many-to-one elimination with a second ratio test among competing refs.
    kp numpy [K, 6], desc tensors [K, 768]."""
    if len(kp1) == 0 or len(kp2) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    d2, idx2 = _top2_distances(desc1, desc2)
    return _mono_eliminate(kp1, np.ones(len(kp1), bool), kp2, len(kp2),
                           d2, idx2, ratio)


def _bidirectional_match(kp1, desc1, kp2, desc2, ratio):
    """bidirectionalMatch (oc_sift.cpp:1420-1489): keep only pairs that are
    each other's mutual ratio-test best match."""
    if len(kp1) == 0 or len(kp2) < 2 or len(kp1) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    d12, i12 = _top2_distances(desc1, desc2)
    d21, i21 = _top2_distances(desc2, desc1)
    return _bi_eliminate(kp1, np.ones(len(kp1), bool),
                         kp2, np.ones(len(kp2), bool),
                         d12, i12, d21, i21, ratio)


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
