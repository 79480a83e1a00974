"""Frames of a specimen under translation and axis-aligned strain.

A mix (``benchmark/traffic/<name>.json``) that names this generator
(``"generator": "affine"``) gives the number of target frames, the
half-range of the translation per axis, the range of the strain and the
axes it acts on (a sign per axis), and the speckle (the Gaussian filter's
sigma and the grey levels' mean and spread).  From the
seed the generator makes, on the device:

* a speckle field: white noise filtered by a Gaussian, scaled to the mean
  and spread, the reference frame being its rounded 8-bit crop;
* each target: the same field at X = c + (x - t - c) / (1 + s) per axis
  (the target shows at x = c + (1 + s)(X - c) + t what the reference shows
  at X, c the frame's centre), resampled by a separable Catmull-Rom cubic
  and rounded to 8 bits.

Every seed gets the same set of translations and strains: each axis's
translations and the strains are the midpoints of ``targets`` equal
strata of their ranges, and the seed only permutes which target takes
which (a Latin hypercube).  The speckle comes from the seed too.  Frames
come back as host uint8 arrays, as a loaded image is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class Sequence:
    """A reference frame and its targets (host uint8, array axis order),
    with each target's imposed field in x, y(, z) order."""

    reference: np.ndarray
    targets: List[np.ndarray]
    translations: np.ndarray  # [T, d]
    strains: np.ndarray  # [T, d]
    center: np.ndarray  # [d]

    def displacement(self, k: int, points: np.ndarray) -> np.ndarray:
        """Target ``k``'s displacement at reference points [N, d] (x, y(,
        z))."""
        return (self.translations[k] + self.strains[k]
                * (np.asarray(points, np.float64) - self.center))


def field_parameters(traffic: dict, dims: int, seed: int):
    """(translations [T, d], strains [T, d]) of the mix for ``seed``."""
    n = int(traffic["targets"])
    rng = np.random.default_rng(seed)
    mid = (np.arange(n) + 0.5) / n
    half = np.asarray(traffic["translation"], np.float64)
    trans = np.stack([-half[a] + 2.0 * half[a] * mid[rng.permutation(n)]
                      for a in range(dims)], -1)
    lo, hi = traffic["strain"]["range"]
    mag = lo + (hi - lo) * mid[rng.permutation(n)]
    strains = mag[:, None] * np.asarray(traffic["strain"]["axes"],
                                        np.float64)[None, :]
    return trans, strains


def _gaussian(field: torch.Tensor, sigma: float, radius: int) -> torch.Tensor:
    """Separable Gaussian over every axis, 'valid' extent: each axis
    loses ``radius`` samples on both sides."""
    t = torch.arange(-radius, radius + 1, dtype=torch.float64)
    taps = torch.exp(-0.5 * (t / sigma) ** 2)
    taps = (taps / taps.sum()).tolist()
    for axis in range(field.dim()):
        n = field.shape[axis] - 2 * radius
        acc = taps[0] * field.narrow(axis, 0, n)
        for k in range(1, 2 * radius + 1):
            acc = acc + taps[k] * field.narrow(axis, k, n)
        field = acc
    return field


def _resample_matrix(positions: torch.Tensor, size: int) -> torch.Tensor:
    """[len(positions), size] Catmull-Rom weights of samples at
    ``positions`` (float64, inside [1, size - 3])."""
    i = torch.floor(positions)
    t = positions - i
    w = torch.stack([0.5 * (-t ** 3 + 2 * t ** 2 - t),
                     0.5 * (3 * t ** 3 - 5 * t ** 2 + 2),
                     0.5 * (-3 * t ** 3 + 4 * t ** 2 + t),
                     0.5 * (t ** 3 - t ** 2)], -1)
    m = torch.zeros((positions.shape[0], size), dtype=torch.float64,
                    device=positions.device)
    rows = torch.arange(positions.shape[0], device=positions.device)
    for k in range(4):
        m[rows, i.long() - 1 + k] = w[:, k]
    return m


def make_sequence(shape, traffic: dict, seed: int, device) -> Sequence:
    """The reference and target frames of ``shape`` (array axis order) for
    ``seed``."""
    dims = len(shape)
    trans, strains = field_parameters(traffic, dims, seed)
    sp = traffic["speckle"]
    radius = int(math.ceil(4.0 * sp["sigma"]))
    size_xyz = np.asarray(list(reversed(shape)), np.float64)
    center = (size_xyz - 1.0) / 2.0
    reach = np.abs(trans).max(0) + np.abs(strains).max(0) * center
    pad = int(math.ceil(reach.max())) + 4
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    noise = torch.randn([n + 2 * (pad + radius) for n in shape],
                        generator=gen, device=device, dtype=torch.float32)
    field = _gaussian(noise.double(), sp["sigma"], radius)
    del noise
    field = (field - field.mean()) / field.std() * sp["std"] + sp["mean"]

    def to_u8(f):
        return torch.clamp(torch.round(f), 0, 255).to(torch.uint8).cpu(
        ).numpy()

    core = tuple(slice(pad, pad + n) for n in shape)
    reference = to_u8(field[core])
    targets = []
    letters = "zyx"[-dims:]
    for k in range(len(trans)):
        out = field
        for a in range(dims):  # array axis a is x-axis index dims-1-a
            ax = dims - 1 - a
            x = torch.arange(shape[a], dtype=torch.float64, device=device)
            src = center[ax] + (x - trans[k, ax] - center[ax]) / (
                1.0 + strains[k, ax])
            m = _resample_matrix(src + pad, field.shape[a])
            spec = (f"o{letters[a]},{letters}->"
                    f"{letters.replace(letters[a], 'o')}")
            out = torch.einsum(spec, m, out)
        targets.append(to_u8(out))
    return Sequence(reference, targets, trans, strains, center)
