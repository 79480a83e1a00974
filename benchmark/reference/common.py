"""What the plain 2D and 3D references share: precision control, the
4th-order gradient, integer-pixel FFT cross-correlation and the local
least-squares strain fit.

Everything here is plain PyTorch written from OpenCorr's published
semantics (oc_gradient.cpp, oc_fftcc.cpp, oc_strain.cpp); it imports
nothing of the program.  The reference runs in float64; the control runs
the same code in float32 with TF32 matrix products on, the step below the
configuration's full float32.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 matrix products and convolutions on or off inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def gradient(img: torch.Tensor, axis: int) -> torch.Tensor:
    """d/d(axis) by the 4th-order central difference
    (f[i-2] - f[i+2]) / 12 + (f[i+1] - f[i-1]) * 2 / 3, with the two
    border samples on each side left at zero (oc_gradient.cpp)."""
    n = img.shape[axis]
    out = torch.zeros_like(img)
    core = ((img.narrow(axis, 0, n - 4) - img.narrow(axis, 4, n - 4)) / 12.0
            + (img.narrow(axis, 3, n - 4) - img.narrow(axis, 1, n - 4))
            * (2.0 / 3.0))
    out.narrow(axis, 2, n - 4).copy_(core)
    return out


def window_index(starts: torch.Tensor, sides) -> tuple:
    """Advanced indices that cut, for each row of ``starts`` [N, d]
    (corner per axis, array order), a window of ``sides`` from an array."""
    d = len(sides)
    idx = []
    for a, s in enumerate(sides):
        shape = [1] * (d + 1)
        shape[a + 1] = s
        ar = torch.arange(s, device=starts.device).reshape(shape)
        idx.append(starts[:, a].reshape([-1] + [1] * d) + ar)
    return tuple(idx)


def fftcc(ref: torch.Tensor, tar: torch.Tensor, centers: torch.Tensor,
          radius, block: int):
    """Integer-pixel displacement by zero-mean cross-correlation
    (oc_fftcc.cpp), every POI seeded at zero.

    ``ref``/``tar``: integer-valued arrays, array axis order, in the
    precision the correlation is computed in;
    ``centers`` [N, d] integer POI positions in array order; ``radius``
    per axis.  Each POI compares the 2r windows of the two images that
    start r before it; a window that would leave the image skips the POI.
    The correlation of the raw integer windows is exact after rounding
    (float64 FFT error is far below 0.5), and the zero-mean correction is
    the same for every circular shift, so its first maximum in scan order
    is the reference's integer peak.  Returns (shift [N, d] int64 in array
    order, zncc [N], valid [N])."""
    d = ref.dim()
    sides = [2 * r for r in radius]
    rad = torch.tensor(radius, device=ref.device)
    dims = torch.tensor(ref.shape, device=ref.device)
    valid = ((centers >= rad) & (centers < dims - rad)).all(dim=1)
    n = centers.shape[0]
    shift = torch.zeros((n, d), dtype=torch.int64, device=ref.device)
    zncc = torch.zeros(n, dtype=ref.dtype, device=ref.device)
    sizes = torch.tensor(sides, device=ref.device)
    count = 1
    for s in sides:
        count *= s
    axes = tuple(range(1, d + 1))
    for b0 in range(0, n, block):
        c = centers[b0:b0 + block]
        starts = torch.minimum(torch.clamp(c - rad, min=0), dims - sizes)
        idx = window_index(starts, sides)
        rw = ref[idx]
        tw = tar[idx]
        raw = torch.fft.irfftn(torch.conj(torch.fft.rfftn(rw, dim=axes))
                               * torch.fft.rfftn(tw, dim=axes),
                               s=sides, dim=axes)
        exact = torch.round(raw).reshape(c.shape[0], -1)
        best = torch.argmax(exact, dim=1)
        rs = rw.reshape(c.shape[0], -1).sum(1)
        ts = tw.reshape(c.shape[0], -1).sum(1)
        peak = exact.gather(1, best[:, None])[:, 0] - rs * ts / count
        rz = rw - rw.mean(dim=axes, keepdim=True)
        tz = tw - tw.mean(dim=axes, keepdim=True)
        norm = torch.sqrt((rz * rz).sum(dim=axes) * (tz * tz).sum(dim=axes))
        zncc[b0:b0 + block] = peak / norm
        rem = best
        for a in reversed(range(d)):
            s = sides[a]
            k = rem % s
            rem = rem // s
            shift[b0:b0 + block, a] = torch.where(k > radius[a], k - s, k)
    shift = torch.where(valid[:, None], shift, torch.zeros_like(shift))
    return shift, zncc, valid


def strain(coords: torch.Tensor, disp: torch.Tensor, zncc: torch.Tensor,
           radius: float, neighbor_min: int, zncc_min: float, block: int):
    """Cauchy strain by a local first-order least-squares fit
    (oc_strain.cpp): for each POI whose ZNCC reaches ``zncc_min``, the
    POIs strictly closer than ``radius`` whose ZNCC reaches it too (the
    POI itself included) fit each displacement component as a + g . dx;
    with at least ``neighbor_min`` of them the strain is the symmetric
    part of the gradient, else zero.  A POI with fewer than
    ``neighbor_min`` POIs within ``radius`` (``<=``, ZNCC aside) takes its
    ``neighbor_min`` nearest instead (the k-nearest search), then the ZNCC
    filter.  ``coords``, ``disp`` [N, d] in x, y(, z) order.  Returns
    [N, 3] (exx, eyy, exy) or [N, 6] (exx, eyy, ezz, exy, eyz, ezx)."""
    n, d = coords.shape
    dt = disp.dtype
    ok = zncc >= zncc_min
    grads = torch.zeros((n, d, d), dtype=dt, device=disp.device)
    count = torch.zeros(n, dtype=dt, device=disp.device)
    r2 = float(radius) * float(radius)
    kmin = min(int(neighbor_min), n)
    for b0 in range(0, n, block):
        q = coords[b0:b0 + block]
        delta = coords[None, :, :] - q[:, None, :]  # [Q, N, d]
        dist2 = (delta * delta).sum(-1)
        near = dist2 < r2
        few = (dist2 <= r2).sum(1) < neighbor_min
        if bool(few.any()):
            knn = torch.zeros_like(near)
            knn.scatter_(1, torch.topk(dist2, kmin, dim=1,
                                       largest=False).indices, True)
            near = torch.where(few[:, None], knn, near)
        w = (near & ok[None, :]).to(dt)
        design = torch.cat([torch.ones_like(delta[..., :1]), delta], -1)
        normal = torch.einsum("qn,qna,qnb->qab", w, design, design)
        rhs = torch.einsum("qn,qna,nc->qac", w, design, disp)
        sol = torch.linalg.solve(
            normal + torch.eye(d + 1, dtype=dt, device=disp.device)
            * (w.sum(1) < neighbor_min)[:, None, None].to(dt), rhs)
        grads[b0:b0 + block] = sol[:, 1:, :].transpose(1, 2)  # [c, axis]
        count[b0:b0 + block] = w.sum(1)
    do = ok & (count >= neighbor_min)
    g = grads
    if d == 2:
        e = torch.stack([g[:, 0, 0], g[:, 1, 1],
                         0.5 * (g[:, 0, 1] + g[:, 1, 0])], -1)
    else:
        e = torch.stack([g[:, 0, 0], g[:, 1, 1], g[:, 2, 2],
                         0.5 * (g[:, 0, 1] + g[:, 1, 0]),
                         0.5 * (g[:, 1, 2] + g[:, 2, 1]),
                         0.5 * (g[:, 2, 0] + g[:, 0, 2])], -1)
    return torch.where(do[:, None], e, torch.zeros_like(e))
