"""Common base for the DIC and DVC modules.

Mirrors the abstract ``DIC`` and ``DVC`` classes (``oc_dic.h:43-86``): a
module holds the reference and target images (volumes) and the subset
radii, and exposes ``prepare()`` and ``compute(poi_table)``.  ``compute``
returns a new POI table.

``chunk_size`` bounds device memory: the queue is processed in fixed-size
chunks, the last one padded with replicas of the final POI, and the padding
is dropped.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.poi import POITable2D, POITable3D
from ..utils import timing
from ..utils.precision import DeviceLike, resolve_device

# ZNCC failure codes (oc_dic.h:28-34).
ZNCC_RESET = 0.0
ZNCC_FEATURES_INSUFFICIENT = -1.0
ZNCC_RANSAC_INCONSISTENT = -2.0
ZNCC_ABORTED = -3.0
ZNCC_NOT_CONVERGED = -4.0
ZNCC_NAN = -5.0


def _pad_edge(a: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])])


def chunked(fn, table, chunk_size: Optional[int], *extras):
    """Apply ``fn(sub_table, *sub_extras) -> sub_table`` over fixed-size POI
    chunks of a 2D or 3D table.  ``extras`` are per-POI tensors (leading
    axis = queue length) padded and sliced alongside the table."""
    n = table.n
    if chunk_size is None or n <= chunk_size:
        return fn(table, *extras)
    pad = -n % chunk_size
    if pad:
        table = table.map(lambda a: _pad_edge(a, pad))
        extras = tuple(_pad_edge(a, pad) for a in extras)
    outs = []
    for start in range(0, n + pad, chunk_size):
        cut = lambda a: a[start: start + chunk_size]
        outs.append(fn(table.map(cut), *(cut(a) for a in extras)))
    return type(table)(*(torch.cat([getattr(o, f) for o in outs])[:n]
                         for f in table.FIELDS))


def budget_chunk(chunk_size: Optional[int], rx: int, ry: int,
                 budget: int = 40_000_000) -> Optional[int]:
    """Effective POI chunk for a 2D refine kernel: the user's ``chunk_size``
    capped by a poi*pixel working-set budget.  40M keeps the flagship 30k
    r=16 queue one chunk, while a 38.4k r=30 queue splits into 4."""
    if chunk_size is None:
        return None
    s = (2 * rx + 1) * (2 * ry + 1)
    return min(chunk_size, max(1024, budget // s))


def eval_margin(margin: Optional[int], radii, sides) -> Optional[int]:
    """The windowed eval's margin, or None (the global path) where the
    image, volume or halo-extended block (``sides``, x first, as ``radii``)
    is too small for the window: min(side - 2r) - 1 < 2 * margin."""
    if margin is not None and min(
            s - 2 * r for s, r in zip(sides, radii)) - 1 < 2 * margin:
        return None
    return margin


def sort_by_zncc(table):
    """Descending ZNCC order, stable (``sortByZNCC``, oc_dic.cpp:57): (the
    reordered table, the permutation as a numpy int64 array)."""
    order = np.argsort(-table.zncc.cpu().numpy(), kind="stable")
    idx = torch.from_numpy(order).to(table.device)
    return table.map(lambda a: a[idx]), order


def _as_mat(img):
    """Accept Image2D wrappers, numpy arrays or tensors."""
    return getattr(img, "mat", img)


def upload(img, device: torch.device) -> torch.Tensor:
    """An image, volume, array or tensor as a contiguous float32 tensor on
    ``device``.  Integer host data crosses at its native width and is cast
    on the device (uint8/16 -> f32 is exact)."""
    m = _as_mat(img)
    if isinstance(m, torch.Tensor):
        return m.to(device=device, dtype=torch.float32).contiguous()
    arr = np.ascontiguousarray(m)
    return torch.from_numpy(arr).to(device).to(torch.float32)


class Module2D:
    """Base for 2D modules: image state + subset radii (oc_dic.h:43-64).
    ``layer`` names the module's spans and counters (``utils/timing``)."""

    layer = "module"

    def __init__(self, subset_radius_x: int, subset_radius_y: int,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.subset_radius_x = int(subset_radius_x)
        self.subset_radius_y = int(subset_radius_y)
        self.ref_img: Optional[torch.Tensor] = None
        self.tar_img: Optional[torch.Tensor] = None
        self.self_adaptive = False

    def _upload(self, img) -> torch.Tensor:
        return upload(img, self.device)

    def set_images(self, ref_img, tar_img) -> None:
        with timing.span(self.layer + ".upload"):
            self.ref_img = self._upload(ref_img)
            self.tar_img = self._upload(tar_img)

    def set_subset_radii(self, rx: int, ry: int) -> None:
        self.subset_radius_x = int(rx)
        self.subset_radius_y = int(ry)

    def set_self_adaptive(self, flag: bool) -> None:
        """Per-POI subset radii from the table's ``sr`` (the refiners that
        support them, ICGN2D1/2 and ICLM2D1/2)."""
        self.self_adaptive = bool(flag)

    def _check_table(self, table) -> None:
        if not isinstance(table, self.table_type):
            raise TypeError(f"{type(self).__name__} takes "
                            f"{self.table_type.__name__}, got "
                            f"{type(table).__name__}")
        if table.device != self.device:
            raise ValueError(f"POI table on {table.device}, module on "
                             f"{self.device}")

    table_type = POITable2D

    def prepare(self) -> None:  # pragma: no cover - overridden
        pass


class Module3D(Module2D):
    """Base for DVC modules: volume state + subset radii (oc_dic.h:66-86).
    ``ref_img``/``tar_img`` hold the [Z, Y, X] volumes; ``ref_vol`` and
    ``tar_vol`` name them as the reference does."""

    table_type = POITable3D

    def __init__(self, subset_radius_x: int, subset_radius_y: int,
                 subset_radius_z: int, device: DeviceLike = None):
        super().__init__(subset_radius_x, subset_radius_y, device)
        self.subset_radius_z = int(subset_radius_z)

    @property
    def ref_vol(self) -> Optional[torch.Tensor]:
        return self.ref_img

    @property
    def tar_vol(self) -> Optional[torch.Tensor]:
        return self.tar_img

    def set_subset_radii(self, rx: int, ry: int, rz: int) -> None:
        super().set_subset_radii(rx, ry)
        self.subset_radius_z = int(rz)

    def set_self_adaptive(self, flag: bool) -> None:
        if flag:
            raise NotImplementedError("DVC has no self-adaptive subsets")
