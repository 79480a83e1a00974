"""ICGN3D1's Gauss-Newton step around the 3D lattice kernel (kernel 3).

An iteration of ``icgn.icgn3d1``'s lattice eval warps every subset sample,
guards it, localises it in its POI's coefficient window and cuts the POI's
block: the **prologue** (:func:`lattice_prologue_3d`), which gives kernel 3
its inputs.  From the samples' values, whatever eval made them, the
**residual** (:func:`residual_3d`) gives each POI its fail flag, its
ZNSSD and the 12 sums of the steepest-descent images times the error
image (oc_icgn.cpp:1390-1430), which the small [N]-sized step turns into
the warp update.

Each has a plain PyTorch version here, which CPU tensors take (float32 or
float64), and a CUDA entry point in ``csrc/lattice3d.cu`` beside kernel 3,
which CUDA float32 tensors take; anything else raises.  The prologue's
kernel rounds as its plain version, bit for bit.  The residual's kernels
sum in another (fixed) order than PyTorch's reductions and read the
reference side from the volumes at the subset corners, never the
[N, 12, S] steepest-descent tensor; their sums agree with the plain
version's to float32 rounding of a sum.  The reference side
(:func:`reference_3d`) takes the same route: it keeps that tensor and the
zero-mean subsets for the plain version alone.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from typing import Optional

import torch

from . import _kernels, linalg
from .window3d import gather_windows_3d

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_I32 = torch.int32


def local_grid_3d(rx: int, ry: int, rz: int, dtype, device):
    """The subset's local coordinates xl, yl, zl, each [1, S], x fastest,
    then y, then z."""
    zg, yg, xg = torch.meshgrid(
        *(torch.arange(-r, r + 1, dtype=dtype, device=device)
          for r in (rz, ry, rx)), indexing="ij")
    return tuple(a.reshape(1, -1) for a in (xg, yg, zg))


def warped_3d(wmat: torch.Tensor, row: int, c: torch.Tensor, grid):
    """Warped coordinate ``row`` of every sample, [N, S]:
    c + (((w0*xl + w1*yl) + w2*zl) + w3), each operation rounded."""
    xl, yl, zl = grid
    return c[:, None] + (wmat[:, row, 0, None] * xl
                         + wmat[:, row, 1, None] * yl
                         + wmat[:, row, 2, None] * zl
                         + wmat[:, row, 3, None])


def window_local_3d(gxc, gyc, gzc, wcx, wcy, wcz, *, vol_shape, sides):
    """Window-local coordinates of warped samples ([N, S] each) in their
    POI's coefficient window (corner ``wc*`` [N], ``sides`` (swx, swy,
    swz)).  Returns ``(lx, ly, lz, ex, ey, ez, oob)``: the local
    coordinates (2 where a sample leaves the volume, or is NaN), their
    integer floors (bounded before the cast) and ``oob``, the samples
    out of the volume or out of [1, sw - 3] of their window."""
    dz_, dy_, dx_ = vol_shape
    fdt = gxc.dtype
    two = torch.full((), 2.0, dtype=fdt, device=gxc.device)
    # global range guard: the float comparisons of the global eval
    oob = ((gxc < 1) | (gyc < 1) | (gzc < 1)
           | (gxc >= dx_ - 2) | (gyc >= dy_ - 2) | (gzc >= dz_ - 2)
           | torch.isnan(gxc) | torch.isnan(gyc) | torch.isnan(gzc))
    loc = [torch.where(oob, two, g - wc.to(fdt)[:, None])
           for g, wc in ((gxc, wcx), (gyc, wcy), (gzc, wcz))]
    # integer window-exit test, on values bounded before the cast
    flo = [torch.floor(lc.clamp(-9.0, sw + 9.0)).to(_I32)
           for lc, sw in zip(loc, sides)]
    for f, sw in zip(flo, sides):
        oob |= (f < 1) | (f > sw - 3)
    return (*loc, *flo, oob)


def lattice_prologue_3d_plain(wmat, xs, ys, zs, wcx, wcy, wcz, coeff, *,
                              rx: int, ry: int, rz: int, margin: int,
                              d_wobble: int):
    """The prologue in PyTorch (see :func:`lattice_prologue_3d`)."""
    dz_, dy_, dx_ = coeff.shape
    dev = coeff.device
    fdt = coeff.dtype
    n = xs.shape[0]
    sx, sy, sz = 2 * rx + 1, 2 * ry + 1, 2 * rz + 1
    sides = tuple(2 * (r + margin) + 1 for r in (rx, ry, rz))
    swx, swy, swz = sides
    D = d_wobble
    pw = 1 + D
    wlat = 4 + 2 * D
    elx, ely, elz = sx + wlat - 1, sy + wlat - 1, sz + wlat - 1
    grid = local_grid_3d(rx, ry, rz, fdt, dev)
    gxc, gyc, gzc = (warped_3d(wmat, row, c, grid)
                     for row, c in enumerate((xs, ys, zs)))
    lx, ly, lz, exf, eyf, ezf, oob = window_local_3d(
        gxc, gyc, gzc, wcx, wcy, wcz, vol_shape=coeff.shape, sides=sides)
    del gxc, gyc, gzc
    shp = (n, sz, sy, sx)
    xi, yi, zi = exf.reshape(shp), eyf.reshape(shp), ezf.reshape(shp)
    fx = lx.reshape(shp) - xi.to(fdt)
    fy = ly.reshape(shp) - yi.to(fdt)
    fz = lz.reshape(shp) - zi.to(fdt)
    del lx, ly, lz
    oob4 = oob.reshape(shp)
    # lattice base from the center sample, in padded window coords
    bx0 = torch.clamp(xi[:, rz, ry, rx] + pw - rx - 1 - D, 0,
                      swx + 2 * pw - elx)
    by0 = torch.clamp(yi[:, rz, ry, rx] + pw - ry - 1 - D, 0,
                      swy + 2 * pw - ely)
    bz0 = torch.clamp(zi[:, rz, ry, rx] + pw - rz - 1 - D, 0,
                      swz + 2 * pw - elz)
    # out-of-range samples must contribute nothing: -1 matches no slot
    neg = torch.full((), -1, dtype=_I32, device=dev)
    iix = torch.arange(sx, dtype=_I32, device=dev)
    iiy = torch.arange(sy, dtype=_I32, device=dev)[:, None]
    iiz = torch.arange(sz, dtype=_I32, device=dev)[:, None, None]
    pdx = torch.where(oob4, neg, xi + (pw - 1) - bx0[:, None, None, None]
                      - iix)
    pdy = torch.where(oob4, neg, yi + (pw - 1) - by0[:, None, None, None]
                      - iiy)
    pdz = torch.where(oob4, neg, zi + (pw - 1) - bz0[:, None, None, None]
                      - iiz)
    del xi, yi, zi
    doomed = oob4.flatten(1).any(dim=1)
    wobble = (((pdx < 0) | (pdx > 2 * D) | (pdy < 0) | (pdy > 2 * D)
               | (pdz < 0) | (pdz > 2 * D)) & ~oob4).flatten(1).any(dim=1)

    def block(b0, wc, sw, el, dim):
        """Volume coordinates [N, el] of a block at padded-window base
        ``b0``, clamped into the volume, and whether each lies inside the
        window (the zero padding outside it)."""
        local = b0.long()[:, None] - pw + torch.arange(el, device=dev)
        inside = (local >= 0) & (local < sw)
        return (wc.long()[:, None] + local).clamp(0, dim - 1), inside

    zc, zin = block(bz0, wcz, swz, elz, dz_)
    yc, yin = block(by0, wcy, swy, ely, dy_)
    xc, xin = block(bx0, wcx, swx, elx, dx_)
    vals = coeff[zc[:, :, None, None], yc[:, None, :, None],
                 xc[:, None, None, :]]
    inside = (zin[:, :, None, None] & yin[:, None, :, None]
              & xin[:, None, None, :])
    eblk = torch.where(inside, vals, torch.zeros((), device=dev))
    return pdz, pdy, pdx, fz, fy, fx, eblk, doomed, wobble


def _check(name, t, dev, dtype):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                         f"{dev}, got {t.dtype} on {t.device}")


def _device_route(t: torch.Tensor) -> bool:
    """True for the kernels (CUDA float32), False for the plain version
    (CPU); raises for anything else."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda" and t.dtype == torch.float32:
        return True
    raise ValueError(f"unsupported tensor: {t.dtype} on {t.device} (the "
                     f"kernels take CUDA float32, the plain version CPU)")


def _bind(lib: ctypes.CDLL):
    pro = lib.oc_icgn3d_prologue
    pro.argtypes = [_P] * 17 + [_I] * 9 + [_P]
    pro.restype = _I
    res = lib.oc_icgn3d_residual
    res.argtypes = [_P] * 18 + [_I] * 8 + [_F, _F, _P]
    res.restype = _I
    parts = lib.oc_icgn3d_parts
    parts.argtypes = [_I]
    parts.restype = _I
    return pro, res, parts


def lattice_prologue_3d(wmat: torch.Tensor, xs: torch.Tensor,
                        ys: torch.Tensor, zs: torch.Tensor,
                        wcx: torch.Tensor, wcy: torch.Tensor,
                        wcz: torch.Tensor, coeff: torch.Tensor, *, rx: int,
                        ry: int, rz: int, margin: int, d_wobble: int):
    """Kernel 3's inputs for one iteration of the windowed lattice eval.

    ``wmat`` [N, 4, 4] warps, ``xs``/``ys``/``zs`` [N] subset centers,
    ``wc*`` [N] int32 corners of the POIs' coefficient windows (half-extent
    r + ``margin``, inside the volume), ``coeff`` the coefficient volume.
    Every sample is warped, guarded against the volume (NaN out of range)
    and against its window ([1, sw - 3] after the floor), and placed on a
    lattice of wobble ``d_wobble`` whose base the center sample sets.
    Returns ``(pdz, pdy, pdx, fz, fy, fx, eblk, doomed, wobble)``: int32
    placement offsets [N, sz, sy, sx] (-1 out of range), the fractional
    parts, the blocks [N, sz+w-1, sy+w-1, sx+w-1] (w = 4 + 2D) cut from the
    window with zeros outside it, and per POI whether any sample is out of
    range and whether any in-range sample's offset leaves [0, 2D]."""
    if not _device_route(coeff):
        return lattice_prologue_3d_plain(wmat, xs, ys, zs, wcx, wcy, wcz,
                                         coeff, rx=rx, ry=ry, rz=rz,
                                         margin=margin, d_wobble=d_wobble)
    dev = coeff.device
    n = xs.shape[0]
    for name, t, dt in (("wmat", wmat, torch.float32),
                        ("xs", xs, torch.float32), ("ys", ys, torch.float32),
                        ("zs", zs, torch.float32), ("wcx", wcx, _I32),
                        ("wcy", wcy, _I32), ("wcz", wcz, _I32),
                        ("coeff", coeff, torch.float32)):
        _check(name, t, dev, dt)
    if tuple(wmat.shape) != (n, 4, 4) or coeff.dim() != 3 or any(
            t.shape != (n,) for t in (xs, ys, zs, wcx, wcy, wcz)):
        raise ValueError("need wmat [N, 4, 4], [N] centers and corners and "
                         "a 3D volume")
    side = (n, 2 * rz + 1, 2 * ry + 1, 2 * rx + 1)
    w = 4 + 2 * d_wobble
    offs = [torch.empty(side, dtype=_I32, device=dev) for _ in range(3)]
    fracs = [torch.empty(side, dtype=torch.float32, device=dev)
             for _ in range(3)]
    eblk = torch.empty((n, *(a + w - 1 for a in side[1:])),
                       dtype=torch.float32, device=dev)
    doomed = torch.empty(n, dtype=torch.bool, device=dev)
    wobble = torch.empty(n, dtype=torch.bool, device=dev)
    with _kernels.on_device(dev):
        fn = _bind(_kernels.load("lattice3d"))[0]
        _kernels.launch(lattice_prologue_3d, lambda: fn(
            wmat.data_ptr(), xs.data_ptr(), ys.data_ptr(), zs.data_ptr(),
            wcx.data_ptr(), wcy.data_ptr(), wcz.data_ptr(), coeff.data_ptr(),
            *(t.data_ptr() for t in (*offs, *fracs, eblk, doomed, wobble)),
            n, rz, ry, rx, *coeff.shape, margin, d_wobble,
            torch.cuda.current_stream(dev).cuda_stream),
            shape=(*side, margin, d_wobble))
    return (*offs, *fracs, eblk, doomed, wobble)


lattice_prologue_3d.launches = 0  # kernel launches, for run-level checks
# a dict: launches by shape (n, sz, sy, sx, margin, D), counted while set
lattice_prologue_3d.shapes = None
# a list: (start, end) CUDA events and the shape of a launch
lattice_prologue_3d.events = None


@dataclass
class Reference3D:
    """The reference side of one ICGN3D1 chunk: subset corners ``x0``,
    ``y0``, ``z0`` [N] int32, the volumes the residual reads (``vol``,
    ``gx``, ``gy``, ``gz``), the subsets' means ``mean`` [N] and zero-mean
    norms ``rn`` [N], the inverse Hessians ``hinv`` [N, 12, 12], and, kept
    for the plain version alone, the [N, S] zero-mean subsets ``zm`` and
    the [N, 12, S] steepest-descent images ``sd`` (None where the
    kernels take the residual)."""
    x0: torch.Tensor
    y0: torch.Tensor
    z0: torch.Tensor
    vol: torch.Tensor
    gx: torch.Tensor
    gy: torch.Tensor
    gz: torch.Tensor
    mean: Optional[torch.Tensor] = None
    rn: Optional[torch.Tensor] = None
    hinv: Optional[torch.Tensor] = None
    zm: Optional[torch.Tensor] = None
    sd: Optional[torch.Tensor] = None


def _subsets_3d(ref: Reference3D, rx: int, ry: int, rz: int):
    """The subsets' means [N, 1], zero-mean subsets [N, S] and
    steepest-descent images [N, 12, S] in the 3D p order, g, g*xl, g*yl,
    g*zl for g in gx, gy, gz (oc_icgn.cpp:1314-1325)."""
    n = ref.x0.shape[0]
    sx, sy, sz = 2 * rx + 1, 2 * ry + 1, 2 * rz + 1
    s = sx * sy * sz

    def subsets(vol):
        return gather_windows_3d(vol, ref.z0, ref.y0, ref.x0, sz, sy,
                                 sx).reshape(n, s)

    ref_sub = subsets(ref.vol)
    mean = ref_sub.mean(dim=1, keepdim=True)
    zm = ref_sub - mean
    del ref_sub
    grid = local_grid_3d(rx, ry, rz, ref.vol.dtype, ref.vol.device)
    sd = torch.empty((n, 12, s), dtype=ref.vol.dtype, device=ref.vol.device)
    for a, g in enumerate((ref.gx, ref.gy, ref.gz)):
        gs = subsets(g)
        sd[:, 4 * a] = gs
        for b, m in enumerate(grid):
            sd[:, 4 * a + 1 + b] = gs * m
    return mean, zm, sd


def reference_3d(gx, gy, gz, ref_vol, xs, ys, zs, *, rx: int, ry: int,
                 rz: int) -> Reference3D:
    """The reference side of a chunk (oc_icgn.cpp:1300-1325): subsets at
    the (int)-truncated corners, their zero-mean values and norms, and the
    inverse Hessians of their steepest-descent images.  Where the kernels
    take the residual (CUDA float32), the [N, 12, S] images are freed
    here and the residual reads the volumes."""
    dz_, dy_, dx_ = ref_vol.shape
    ref = Reference3D(
        x0=torch.clamp(xs.to(_I32) - rx, 0, dx_ - (2 * rx + 1)),  # (int)
        y0=torch.clamp(ys.to(_I32) - ry, 0, dy_ - (2 * ry + 1)),
        z0=torch.clamp(zs.to(_I32) - rz, 0, dz_ - (2 * rz + 1)),
        vol=ref_vol.contiguous(), gx=gx.contiguous(), gy=gy.contiguous(),
        gz=gz.contiguous())
    mean, zm, sd = _subsets_3d(ref, rx, ry, rz)
    rn = torch.sqrt(torch.sum(zm * zm, dim=1))
    hinv = linalg.inv_small(torch.bmm(sd, sd.transpose(1, 2)))
    plain = not _device_route(ref_vol)
    return replace(ref, mean=mean[:, 0].contiguous(), rn=rn, hinv=hinv,
                   zm=zm if plain else None, sd=sd if plain else None)


def residual_3d_plain(tval, fail0, ref: Reference3D, wmat, zs, *, rx: int,
                      ry: int, rz: int, z_guard=None):
    """The residual in PyTorch (see :func:`residual_3d`), from the
    reference side's ``zm`` and ``sd``, or from its volumes where they
    were freed."""
    if ref.sd is None:
        _, zm, sd = _subsets_3d(ref, rx, ry, rz)
    else:
        zm, sd = ref.zm, ref.sd
    # A negative sample, the -1 sentinel included, fails the POI, as does
    # a sample past the z guards.
    fail_any = torch.any(tval < 0.0, dim=1)
    if fail0 is not None:
        fail_any |= fail0
    if z_guard is not None:
        z_lo, z_hi = z_guard
        grid = local_grid_3d(rx, ry, rz, tval.dtype, tval.device)
        gzc = warped_3d(wmat, 2, zs, grid)
        fail_any |= torch.any((gzc < z_lo) | (gzc >= z_hi), dim=1)
        del gzc
    tar_zm = tval - tval.mean(dim=1, keepdim=True)
    tn = torch.sqrt(torch.sum(tar_zm * tar_zm, dim=1))
    err = tar_zm * (ref.rn / tn)[:, None] - zm
    del tar_zm
    znssd = torch.sum(err * err, dim=1) / (ref.rn * ref.rn)
    num = torch.bmm(sd, err[:, :, None])[:, :, 0]
    return fail_any, znssd, num


def residual_3d(tval: torch.Tensor, fail0: Optional[torch.Tensor],
                ref: Reference3D, wmat: torch.Tensor, zs: torch.Tensor, *,
                rx: int, ry: int, rz: int, z_guard=None):
    """One Gauss-Newton residual from the samples' values ``tval`` [N, S].

    ``fail0`` [N] bool (or None): POIs failed before the eval (the
    lattice eval's out-of-range samples).  ``z_guard`` (lo, hi) or None:
    a sample warped (by ``wmat``'s z row about ``zs``) to z < lo or
    z >= hi fails its POI.  With m the mean of a POI's values and
    tn = sqrt(sum (t - m)^2), err = (t - m) (rn / tn) - (ref - mean).
    Returns ``(fail, znssd, num)``: [N] bool, the POI failed (any value
    below 0, ``fail0`` or a z guard); [N] sum err^2 / rn^2; [N, 12]
    sum sd_k err for the 12 steepest-descent images."""
    if not _device_route(tval):
        return residual_3d_plain(tval, fail0, ref, wmat, zs, rx=rx, ry=ry,
                                 rz=rz, z_guard=z_guard)
    dev = tval.device
    n, s = tval.shape
    dz_, dy_, dx_ = ref.vol.shape
    if s != (2 * rx + 1) * (2 * ry + 1) * (2 * rz + 1):
        raise ValueError(f"tval has {s} samples a POI, not a subset's")
    f32 = torch.float32
    for name, t, dt in (("tval", tval, f32), ("wmat", wmat, f32),
                        ("zs", zs, f32), ("vol", ref.vol, f32),
                        ("gx", ref.gx, f32), ("gy", ref.gy, f32),
                        ("gz", ref.gz, f32), ("x0", ref.x0, _I32),
                        ("y0", ref.y0, _I32), ("z0", ref.z0, _I32),
                        ("mean", ref.mean, f32), ("rn", ref.rn, f32)):
        _check(name, t, dev, dt)
    if fail0 is not None:
        _check("fail0", fail0, dev, torch.bool)
    if any(g.shape != ref.vol.shape for g in (ref.gx, ref.gy, ref.gz)):
        raise ValueError("the gradient volumes differ from the reference's")
    z_lo, z_hi = z_guard if z_guard is not None else (0.0, 0.0)
    fail = torch.empty(n, dtype=torch.bool, device=dev)
    znssd = torch.empty(n, dtype=f32, device=dev)
    num = torch.empty((n, 12), dtype=f32, device=dev)
    with _kernels.on_device(dev):
        _, fn, parts = _bind(_kernels.load("lattice3d"))
        blocks = n * parts(s)
        scratch = torch.empty(blocks * 15, dtype=f32, device=dev)
        failp = torch.empty(blocks, dtype=torch.uint8, device=dev)
        _kernels.launch(residual_3d, lambda: fn(
            tval.data_ptr(), None if fail0 is None else fail0.data_ptr(),
            wmat.data_ptr(), zs.data_ptr(), ref.vol.data_ptr(),
            ref.gx.data_ptr(), ref.gy.data_ptr(), ref.gz.data_ptr(),
            ref.x0.data_ptr(), ref.y0.data_ptr(), ref.z0.data_ptr(),
            ref.mean.data_ptr(), ref.rn.data_ptr(), scratch.data_ptr(),
            failp.data_ptr(), fail.data_ptr(), znssd.data_ptr(),
            num.data_ptr(), n, rz, ry, rx, dz_, dy_, dx_,
            int(z_guard is not None), z_lo, z_hi,
            torch.cuda.current_stream(dev).cuda_stream),
            shape=(n, 2 * rz + 1, 2 * ry + 1, 2 * rx + 1,
                   z_guard is not None))
    return fail, znssd, num


residual_3d.launches = 0  # calls (four kernel launches each)
# a dict: calls by shape (n, sz, sy, sx, z guarded), counted while set
residual_3d.shapes = None
# a list: (start, end) CUDA events and the shape of a call
residual_3d.events = None
