"""The in-sphere row rule of the descriptor-histogram kernel
(``csrc/desc3d.cu``) on the CPU.

The kernel visits, for each (z, y) row of a keypoint's crop box, only the
x-interval that it finds with two binary searches on either side of the
smallest px^2, testing ``pz2 + (py2 + px2) <= r2`` in float32 as the plain
version does.  That is exact only if the sphere test holds on one
contiguous run of x around that index.  Here the same searches, written
out in numpy float32, must give the sphere test's voxel set, voxel for
voxel, on ``prepare_tables`` output: centred keypoints, keypoints whose
windows are clamped at a face (the keypoint off centre or outside the
box), and boxes of unequal pitch per axis."""

import numpy as np
import pytest
import torch

from opencorr_tpu_torch.ops import desc3d
from opencorr_tpu_torch.ops import sift3d as tops

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)


def _kernel_rows(pz2, py2, px2, r2):
    """(lo, len) per (z, y) row by the kernel's searches."""
    f = np.float32
    xm = int(np.argmin(px2))  # the first of equal minima, as the kernel
    out = np.zeros((len(pz2), len(py2), 2), np.int64)
    for iz, a in enumerate(pz2):
        for iy, b in enumerate(py2):
            def inside(ix):
                return f(a + f(b + px2[ix])) <= r2

            if not inside(xm):
                continue
            lo, hi = 0, xm
            while lo < hi:
                mid = (lo + hi) >> 1
                if inside(mid):
                    hi = mid
                else:
                    lo = mid + 1
            l2, h2 = xm, len(px2) - 1
            while l2 < h2:
                mid = (l2 + h2 + 1) >> 1
                if inside(mid):
                    l2 = mid
                else:
                    h2 = mid - 1
            out[iz, iy] = lo, l2 - lo + 1
    return out


@pytest.mark.parametrize("shape,crop_r,scale,units", [
    ((60, 62, 64), 23, 1.6, (1.0, 1.0, 1.0)),
    ((70, 72, 74), 29, 2.0159, (1.0, 1.0, 1.0)),
    ((40, 44, 48), 18, 2.5398, (2.0, 2.0, 2.0)),
    ((40, 50, 60), None, 0.9, (1.0, 1.5, 2.0)),  # unequal pitch
])
def test_row_intervals_are_the_sphere(shape, crop_r, scale, units):
    crop = ((crop_r,) * 3 if crop_r else tops._sphere_crop(64, scale, units))
    rng = np.random.default_rng(crop[0])
    # centred keypoints, keypoints on and next to each face, and one corner
    pts = [[d // 2 for d in shape]]
    for axis in range(3):
        for c in (0, 1, 3, shape[axis] - 1, shape[axis] - 2):
            p = [int(rng.integers(0, d)) for d in shape]
            p[axis] = c
            pts.append(p)
    pts.append([0, shape[1] - 1, 0])
    zi, yi, xi = (torch.tensor([p[a] for p in pts], dtype=torch.int32)
                  for a in range(3))
    _, tab = desc3d.prepare_tables(shape, xi, yi, zi, crop=crop, scale=scale,
                                   unit_xyz=units)
    r2 = np.float32(desc3d._radii(scale)[0])
    cz, cy, _ = (2 * c + 1 for c in crop)
    p2 = tab[:, 2].numpy()
    for k in range(len(pts)):
        pz2, py2, px2 = p2[k, :cz], p2[k, cz:cz + cy], p2[k, cz + cy:]
        want = (pz2[:, None, None] + (py2[None, :, None]
                                      + px2[None, None, :])) <= r2
        rows = _kernel_rows(pz2, py2, px2, r2)
        ix = np.arange(len(px2))
        got = ((ix >= rows[..., :1]) & (ix < rows[..., :1] + rows[..., 1:]))
        assert want.any()
        np.testing.assert_array_equal(got, want)
