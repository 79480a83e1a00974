"""Batched 2D and 3D strain by local first-order polynomial fits.

Reference: ``oc_strain.cpp`` -- per POI with ZNCC above threshold: collect
neighbor POIs inside a subregion radius via k-d tree (KNN fallback with
exactly ``neighbor_number_min`` nearest when the radius search returns
fewer, :160-189), filter by ZNCC (:167), fit u and v against the coordinate
deltas (:195-218), then Cauchy (approximation=1) or Green-Lagrange (=2)
strain from the gradients (:220-233).

A full regular grid takes its neighbors from a fixed offset stencil by
index arithmetic on the device; a scattered cloud gets a fixed-width
neighbor table from one host cKDTree.  The radius mask is re-applied on the
device with nanoflann's strict ``dist < radius``; KNN-fallback rows use their
exact-k set regardless of distance, like ``knnSearch``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import linalg as linalg_ops


def detect_grid_2d(x: np.ndarray, y: np.ndarray):
    """If the POI cloud is a full regular grid, return
    ``(iy, ix, lookup [H, W] int32, gy, gx)`` -- every POI's grid
    coordinates and the grid-cell -> POI-index map; None for scattered or
    holey clouds (those take the k-d-tree path)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.shape[0]
    ux = np.unique(x)
    uy = np.unique(y)
    if len(ux) < 2 or len(uy) < 2 or len(ux) * len(uy) != n:
        return None
    dx = np.diff(ux)
    dy = np.diff(uy)
    gx, gy = dx[0], dy[0]
    if gx <= 0 or gy <= 0 or not (
        np.allclose(dx, gx, rtol=1e-6, atol=1e-6)
        and np.allclose(dy, gy, rtol=1e-6, atol=1e-6)
    ):
        return None
    ix = np.searchsorted(ux, x).astype(np.int32)
    iy = np.searchsorted(uy, y).astype(np.int32)
    lookup = np.full((len(uy), len(ux)), -1, np.int32)
    lookup[iy, ix] = np.arange(n, dtype=np.int32)
    if (lookup < 0).any():  # duplicates / holes
        return None
    return iy, ix, lookup, float(gy), float(gx)


def grid_stencil_2d(gy: float, gx: float, radius: float, neighbor_min: int):
    """In-radius grid offset stencil (strict ``dist < radius``).  Returns
    ``(di [K], dj [K])`` int32 padded to a multiple of 8 with far-away
    sentinels (masked by the strict distance test), or None when a corner
    POI could see fewer than ``neighbor_min`` neighbors (then the exact-KNN
    fallback path must be used)."""
    mj = int(np.ceil(radius / gx))
    mi = int(np.ceil(radius / gy))
    jj, ii = np.meshgrid(np.arange(-mj, mj + 1), np.arange(-mi, mi + 1))
    d2 = (jj * gx) ** 2 + (ii * gy) ** 2
    keep = d2 < radius * radius
    di = ii[keep].astype(np.int32)
    dj = jj[keep].astype(np.int32)
    # worst-case (corner) neighbor count: one quadrant of the stencil
    corner = min(
        int(((di >= 0) & (dj >= 0)).sum()),
        int(((di >= 0) & (dj <= 0)).sum()),
        int(((di <= 0) & (dj >= 0)).sum()),
        int(((di <= 0) & (dj <= 0)).sum()),
    )
    if corner < int(neighbor_min):
        return None
    pad = (-len(di)) % 8
    if pad:
        big = np.int32(1 << 20)  # far outside any grid -> masked out
        di = np.concatenate([di, np.full(pad, big, np.int32)])
        dj = np.concatenate([dj, np.full(pad, big, np.int32)])
    return di, dj


def detect_grid_3d(x: np.ndarray, y: np.ndarray, z: np.ndarray):
    """3D analog of :func:`detect_grid_2d`: returns
    ``(iz, iy, ix, lookup [D, H, W], gz, gy, gx)`` or None."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    n = x.shape[0]
    ux, uy, uz = np.unique(x), np.unique(y), np.unique(z)
    if min(len(ux), len(uy), len(uz)) < 2 or len(ux) * len(uy) * len(uz) != n:
        return None
    gx, gy, gz = np.diff(ux)[0], np.diff(uy)[0], np.diff(uz)[0]
    if min(gx, gy, gz) <= 0 or not (
        np.allclose(np.diff(ux), gx, rtol=1e-6, atol=1e-6)
        and np.allclose(np.diff(uy), gy, rtol=1e-6, atol=1e-6)
        and np.allclose(np.diff(uz), gz, rtol=1e-6, atol=1e-6)
    ):
        return None
    ix = np.searchsorted(ux, x).astype(np.int32)
    iy = np.searchsorted(uy, y).astype(np.int32)
    iz = np.searchsorted(uz, z).astype(np.int32)
    lookup = np.full((len(uz), len(uy), len(ux)), -1, np.int32)
    lookup[iz, iy, ix] = np.arange(n, dtype=np.int32)
    if (lookup < 0).any():
        return None
    return iz, iy, ix, lookup, float(gz), float(gy), float(gx)


def grid_stencil_3d(gz: float, gy: float, gx: float, radius: float,
                    neighbor_min: int):
    """3D analog of :func:`grid_stencil_2d`: returns ``(dk, di, dj)`` or
    None when a corner POI (one octant of the ball) could see fewer than
    ``neighbor_min`` neighbors."""
    mj = int(np.ceil(radius / gx))
    mi = int(np.ceil(radius / gy))
    mk = int(np.ceil(radius / gz))
    kk, ii, jj = np.meshgrid(
        np.arange(-mk, mk + 1), np.arange(-mi, mi + 1),
        np.arange(-mj, mj + 1), indexing="ij")
    d2 = (jj * gx) ** 2 + (ii * gy) ** 2 + (kk * gz) ** 2
    keep = d2 < radius * radius
    dk = kk[keep].astype(np.int32)
    di = ii[keep].astype(np.int32)
    dj = jj[keep].astype(np.int32)
    corner = len(dk)
    for sk in (1, -1):
        for si in (1, -1):
            for sj in (1, -1):
                corner = min(corner, int(
                    ((sk * dk >= 0) & (si * di >= 0) & (sj * dj >= 0)).sum()))
    if corner < int(neighbor_min):
        return None
    pad = (-len(dk)) % 8
    if pad:
        big = np.int32(1 << 20)
        dk = np.concatenate([dk, np.full(pad, big, np.int32)])
        di = np.concatenate([di, np.full(pad, big, np.int32)])
        dj = np.concatenate([dj, np.full(pad, big, np.int32)])
    return dk, di, dj


def grid_neighbors_3d(qiz, qiy, qix, lookup, dk, di, dj):
    """``nb_idx[c, k] = lookup[qiz[c]+dk[k], qiy[c]+di[k], qix[c]+dj[k]]``
    with border masking, on the device."""
    d, h, w = lookup.shape
    nz = qiz[:, None].long() + dk[None, :].long()
    ny = qiy[:, None].long() + di[None, :].long()
    nx = qix[:, None].long() + dj[None, :].long()
    ok = ((nz >= 0) & (nz < d) & (ny >= 0) & (ny < h) & (nx >= 0)
          & (nx < w))
    idx = lookup[nz.clamp(0, d - 1), ny.clamp(0, h - 1), nx.clamp(0, w - 1)]
    return idx, ok


def grid_neighbors_2d(qiy, qix, lookup, di, dj):
    """``nb_idx[c, k] = lookup[qiy[c]+di[k], qix[c]+dj[k]]`` with border
    masking, on the device."""
    h, w = lookup.shape
    ny = qiy[:, None].long() + di[None, :].long()
    nx = qix[:, None].long() + dj[None, :].long()
    ok = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
    idx = lookup[ny.clamp(0, h - 1), nx.clamp(0, w - 1)]
    return idx, ok


def neighbor_lists(query_pts: np.ndarray, cloud_pts: np.ndarray,
                   radius: float, neighbor_min: int):
    """Host-side neighbor precompute (oc_strain.cpp:160-189).

    Returns ``(idx [C, K] int32, ok [C, K] bool, use_radius [C] bool)``:
    per query, up to K candidate neighbor indices into the cloud.  Rows with
    at least ``neighbor_min`` in-radius neighbors get their radius set (the
    device fit re-applies the strict ``dist < radius`` test); the rest get
    exactly ``neighbor_min`` nearest neighbors (``knnSearch`` with
    search_k = neighbor_number_min, oc_nearest_neighbor.cpp:158-165)."""
    from scipy.spatial import cKDTree

    q = np.ascontiguousarray(np.asarray(query_pts, np.float64))
    p = np.ascontiguousarray(np.asarray(cloud_pts, np.float64))
    nq = q.shape[0]
    n = p.shape[0]
    nmin = int(neighbor_min)
    tree = cKDTree(p)

    counts = tree.query_ball_point(q, r=float(radius), return_length=True,
                                   workers=-1)
    counts = np.asarray(counts, np.int64)
    use_radius = counts >= nmin
    kmax = int(max(counts.max(initial=1), min(nmin, n), 1))
    k_cap = -(-kmax // 8) * 8

    dist, idx = tree.query(q, k=k_cap, distance_upper_bound=float(radius),
                           workers=-1)
    dist = np.atleast_2d(dist).reshape(nq, -1)
    idx = np.atleast_2d(idx).reshape(nq, -1)
    ok = np.isfinite(dist)
    idx = np.where(ok, idx, 0).astype(np.int32)

    bad = np.where(~use_radius)[0]
    if bad.size:
        k = min(nmin, n)
        kd, ki = tree.query(q[bad], k=k, workers=-1)
        kd = np.atleast_2d(kd).reshape(bad.size, -1)
        ki = np.atleast_2d(ki).reshape(bad.size, -1)
        kok = np.isfinite(kd)
        row_ok = np.zeros((bad.size, k_cap), bool)
        row_idx = np.zeros((bad.size, k_cap), np.int32)
        row_ok[:, :k] = kok
        row_idx[:, :k] = np.where(kok, ki, 0).astype(np.int32)
        ok[bad] = row_ok
        idx[bad] = row_idx
    return idx, ok, use_radius


def _solve_sym(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for small symmetric PD-ish systems, batched."""
    return linalg_ops.solve_small(a, b)


def _fit_gradients_2d(dx, dy, nu, nv, wf):
    """Least-squares plane fit per query from masked neighbor deltas
    (oc_strain.cpp:195-218: intercept + x + y columns, normal equations)."""
    s0 = torch.sum(wf, dim=1)
    sx = torch.sum(wf * dx, dim=1)
    sy = torch.sum(wf * dy, dim=1)
    sxx = torch.sum(wf * dx * dx, dim=1)
    sxy = torch.sum(wf * dx * dy, dim=1)
    syy = torch.sum(wf * dy * dy, dim=1)
    amat = torch.stack([torch.stack([s0, sx, sy], -1),
                        torch.stack([sx, sxx, sxy], -1),
                        torch.stack([sy, sxy, syy], -1)], dim=-2)

    def rhs(val):
        return torch.stack([torch.sum(wf * val, dim=1),
                            torch.sum(wf * dx * val, dim=1),
                            torch.sum(wf * dy * val, dim=1)], -1)

    gu = _solve_sym(amat, rhs(nu))
    gv = _solve_sym(amat, rhs(nv))
    return gu[:, 1], gu[:, 2], gv[:, 1], gv[:, 2], s0


def strain2d(xs, ys, us, vs, zncc, qx, qy, qzncc, qe_in, nb_idx, nb_ok,
             use_radius, radius: float, zncc_threshold: float,
             neighbor_min: float, *, approximation: int) -> torch.Tensor:
    """Strain for a chunk of query POIs against the full cloud (xs..zncc).
    Returns the updated [C, 3] strain (exx, eyy, exy)."""
    nb = nb_idx.long()
    # Shift displacements by the cloud mean for f32 conditioning (the fitted
    # gradients are invariant; the intercept column absorbs the shift).
    nu = (us - us.mean())[nb]
    nv = (vs - vs.mean())[nb]
    nz = zncc[nb]
    dx = xs[nb] - qx[:, None]
    dy = ys[nb] - qy[:, None]

    r2 = float(np.float32(radius) * np.float32(radius))  # the f32 square
    strict = dx * dx + dy * dy < r2  # nanoflann's dist < radius
    sel = nb_ok & (strict | ~use_radius[:, None])
    wf = (sel & (nz >= zncc_threshold)).to(torch.float32)

    ux, uy, vx, vy, fit_count = _fit_gradients_2d(dx, dy, nu, nv, wf)

    if approximation == 1:  # Cauchy (oc_strain.cpp:220-226)
        exx = ux
        eyy = vy
        exy = 0.5 * (uy + vx)
    else:  # Green-Lagrange (oc_strain.cpp:227-233)
        exx = ux + 0.5 * (ux * ux + vx * vx)
        eyy = vy + 0.5 * (uy * uy + vy * vy)
        exy = 0.5 * (uy + vx + uy * ux + vy * vx)

    do = (qzncc >= zncc_threshold) & (fit_count >= neighbor_min)
    e_new = torch.stack([exx, eyy, exy], dim=-1)
    return torch.where(do[:, None], e_new, qe_in)


def strain2d_grid(xs, ys, us, vs, zncc, qx, qy, qzncc, qe_in, qiy, qix,
                  lookup, di, dj, radius, zncc_threshold, neighbor_min, *,
                  approximation: int) -> torch.Tensor:
    """Grid path: neighbor indices from the offset stencil."""
    nb_idx, nb_ok = grid_neighbors_2d(qiy, qix, lookup, di, dj)
    use_radius = torch.ones(qx.shape, dtype=torch.bool, device=qx.device)
    return strain2d(xs, ys, us, vs, zncc, qx, qy, qzncc, qe_in, nb_idx,
                    nb_ok, use_radius, radius, zncc_threshold, neighbor_min,
                    approximation=approximation)


def _fit_gradients_3d(dx, dy, dz, nu, nv, nw, wf):
    """Least-squares fit per query, intercept + x + y + z columns
    (oc_strain.cpp:303-330, normal equations)."""
    s0 = torch.sum(wf, dim=1)
    sx = torch.sum(wf * dx, dim=1)
    sy = torch.sum(wf * dy, dim=1)
    sz = torch.sum(wf * dz, dim=1)
    sxx = torch.sum(wf * dx * dx, dim=1)
    sxy = torch.sum(wf * dx * dy, dim=1)
    sxz = torch.sum(wf * dx * dz, dim=1)
    syy = torch.sum(wf * dy * dy, dim=1)
    syz = torch.sum(wf * dy * dz, dim=1)
    szz = torch.sum(wf * dz * dz, dim=1)
    amat = torch.stack([torch.stack([s0, sx, sy, sz], -1),
                        torch.stack([sx, sxx, sxy, sxz], -1),
                        torch.stack([sy, sxy, syy, syz], -1),
                        torch.stack([sz, sxz, syz, szz], -1)], dim=-2)

    def rhs(val):
        return torch.stack([torch.sum(wf * val, dim=1),
                            torch.sum(wf * dx * val, dim=1),
                            torch.sum(wf * dy * val, dim=1),
                            torch.sum(wf * dz * val, dim=1)], -1)

    gu = _solve_sym(amat, rhs(nu))
    gv = _solve_sym(amat, rhs(nv))
    gw = _solve_sym(amat, rhs(nw))
    return (gu[:, 1], gu[:, 2], gu[:, 3], gv[:, 1], gv[:, 2], gv[:, 3],
            gw[:, 1], gw[:, 2], gw[:, 3], s0)


def strain3d(xs, ys, zs, us, vs, ws, zncc, qx, qy, qz, qzncc, qe_in,
             nb_idx, nb_ok, use_radius, radius: float,
             zncc_threshold: float, neighbor_min: float, *,
             approximation: int) -> torch.Tensor:
    """3D strain for a chunk of query POIs against the full cloud
    (oc_strain.cpp:372-472).  The displacement means are taken over the
    whole cloud, failed POIs included, as the JAX package does.  Returns
    the updated [C, 6] strain (exx, eyy, ezz, exy, eyz, ezx)."""
    nb = nb_idx.long()
    nu = (us - us.mean())[nb]
    nv = (vs - vs.mean())[nb]
    nw = (ws - ws.mean())[nb]
    nz = zncc[nb]
    dx = xs[nb] - qx[:, None]
    dy = ys[nb] - qy[:, None]
    dz = zs[nb] - qz[:, None]

    r2 = float(np.float32(radius) * np.float32(radius))  # the f32 square
    strict = dx * dx + dy * dy + dz * dz < r2
    sel = nb_ok & (strict | ~use_radius[:, None])
    wf = (sel & (nz >= zncc_threshold)).to(torch.float32)
    return _strain_3d_fit(dx, dy, dz, nu, nv, nw, wf, qzncc, qe_in,
                          zncc_threshold, neighbor_min, approximation)


def _strain_3d_fit(dx, dy, dz, nu, nv, nw, wf, qzncc, qe_in, zncc_threshold,
                   neighbor_min, approximation):
    """The 3D fit and strain of DVC and stereo strain: (exx, eyy, ezz, exy,
    eyz, ezx) where the query passes the gate and has enough neighbours,
    else ``qe_in``."""
    (ux, uy, uz, vx, vy, vz, wx, wy, wz, fit_count) = _fit_gradients_3d(
        dx, dy, dz, nu, nv, nw, wf)

    if approximation == 1:  # Cauchy
        exx, eyy, ezz = ux, vy, wz
        exy = 0.5 * (uy + vx)
        eyz = 0.5 * (vz + wy)
        ezx = 0.5 * (wx + uz)
    else:  # Green-Lagrange
        exx = ux + 0.5 * (ux * ux + vx * vx + wx * wx)
        eyy = vy + 0.5 * (uy * uy + vy * vy + wy * wy)
        ezz = wz + 0.5 * (uz * uz + vz * vz + wz * wz)
        exy = 0.5 * (uy + vx + uy * ux + vy * vx + wy * wx)
        eyz = 0.5 * (vz + wy + uz * uy + vz * vy + wz * wy)
        ezx = 0.5 * (wx + uz + ux * uz + vx * vz + wx * wz)

    do = (qzncc >= zncc_threshold) & (fit_count >= neighbor_min)
    e_new = torch.stack([exx, eyy, ezz, exy, eyz, ezx], dim=-1)
    return torch.where(do[:, None], e_new, qe_in)


def strain3d_grid(xs, ys, zs, us, vs, ws, zncc, qx, qy, qz, qzncc, qe_in,
                  qiz, qiy, qix, lookup, dk, di, dj, radius, zncc_threshold,
                  neighbor_min, *, approximation: int) -> torch.Tensor:
    """Grid path for DVC strain: neighbor indices from the offset
    stencil."""
    nb_idx, nb_ok = grid_neighbors_3d(qiz, qiy, qix, lookup, dk, di, dj)
    use_radius = torch.ones(qx.shape, dtype=torch.bool, device=qx.device)
    return strain3d(xs, ys, zs, us, vs, ws, zncc, qx, qy, qz, qzncc, qe_in,
                    nb_idx, nb_ok, use_radius, radius, zncc_threshold,
                    neighbor_min, approximation=approximation)


def strain2ds(sx2, sy2, xs, ys, zs, us, vs, ws, zncc, qx2, qy2, qx, qy, qz,
              qzncc, qe_in, nb_idx, nb_ok, use_radius, radius: float,
              zncc_threshold: float, neighbor_min: float, *,
              approximation: int) -> torch.Tensor:
    """Stereo strain for a chunk of query POIs (oc_strain.cpp:250-355):
    the neighbours are searched on the view-1 image coordinates (sx2, sy2;
    queries qx2, qy2), the displacement gradients are fitted against the
    reconstructed 3D reference coordinates (xs, ys, zs; queries qx, qy,
    qz).  ``zncc`` is each POI's smallest of its three ZNCCs.  Returns the
    updated [C, 6] strain."""
    nb = nb_idx.long()
    nu = (us - us.mean())[nb]
    nv = (vs - vs.mean())[nb]
    nw = (ws - ws.mean())[nb]
    nz = zncc[nb]
    dx = xs[nb] - qx[:, None]
    dy = ys[nb] - qy[:, None]
    dz = zs[nb] - qz[:, None]

    dx2 = sx2[nb] - qx2[:, None]
    dy2 = sy2[nb] - qy2[:, None]
    r2 = float(np.float32(radius) * np.float32(radius))  # the f32 square
    strict = dx2 * dx2 + dy2 * dy2 < r2
    sel = nb_ok & (strict | ~use_radius[:, None])
    wf = (sel & (nz >= zncc_threshold)).to(torch.float32)
    return _strain_3d_fit(dx, dy, dz, nu, nv, nw, wf, qzncc, qe_in,
                          zncc_threshold, neighbor_min, approximation)


def strain2ds_grid(sx2, sy2, xs, ys, zs, us, vs, ws, zncc, qx2, qy2, qx, qy,
                   qz, qzncc, qe_in, qiy, qix, lookup, di, dj, radius,
                   zncc_threshold, neighbor_min, *,
                   approximation: int) -> torch.Tensor:
    """Grid path for stereo strain: the view-1 image coordinates form the
    grid."""
    nb_idx, nb_ok = grid_neighbors_2d(qiy, qix, lookup, di, dj)
    use_radius = torch.ones(qx.shape, dtype=torch.bool, device=qx.device)
    return strain2ds(sx2, sy2, xs, ys, zs, us, vs, ws, zncc, qx2, qy2, qx,
                     qy, qz, qzncc, qe_in, nb_idx, nb_ok, use_radius, radius,
                     zncc_threshold, neighbor_min,
                     approximation=approximation)
