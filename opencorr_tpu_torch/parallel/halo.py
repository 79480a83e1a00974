"""DVC over a volume split into z-blocks, one block per rank.

The reference runs one process with an OpenMP team over the POI queue.  The
JAX package shards CT volumes in z-blocks over its device mesh; each device
takes boundary slabs from its neighbours, computes the gradient and
coefficient state of its extended block, and refines the POIs of its own
block, with no other communication until the results are gathered.  The
port does the same on ``torch.distributed``: one process per device, the
slabs sent point to point, the results all-gathered.

Halo sizing: a POI touches at most a (2r+1)^3 window, the gradient stencil
adds +-2 and the tricubic prefilter has 15 taps (+-7), so with
``halo = r + 2 + 7`` the block state matches the global one to the
prefilter's tap decay (b7 ~ 1.7e-4).  Warped subsets that leave the halo
hit the range guard and fail -3, like a warp out of the volume.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..data import poi as poi_mod
from ..models import base
from ..models.icgn import ICGN3D1
from ..ops import bspline, gradient, icgn as icgn_ops
from .mesh import mesh_device

_REFINED = 17  # p [12], u0, v0, w0, zncc, iteration


def halo_exchange_z(block: torch.Tensor, halo: int, mesh: DeviceMesh,
                    axis: Optional[str] = None) -> torch.Tensor:
    """Extend this rank's z-block [Bz, Y, X] by its neighbours' slabs:
    [halo + Bz + halo, Y, X].  Each rank sends its bottom ``halo`` planes
    to rank+1 and its top ones to rank-1; the first and last ranks fill
    the side without a neighbour with copies of their boundary plane, so
    that the clamped 15-tap prefilter on the extended block matches the
    global clamped one at the volume's faces (oc_cubic_bspline.cpp:223-351).
    Every rank posts its operations in one order: send down, send up,
    receive from below, receive from above."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    block = block.contiguous()
    from_prev = block[:1].expand((halo,) + block.shape[1:]).clone()
    from_next = block[-1:].expand((halo,) + block.shape[1:]).clone()
    peer = lambda i: dist.get_global_rank(group, i)
    ops = []
    if me + 1 < n:
        ops.append(dist.P2POp(dist.isend, block[-halo:].contiguous(),
                              peer(me + 1), group))
    if me > 0:
        ops.append(dist.P2POp(dist.isend, block[:halo].contiguous(),
                              peer(me - 1), group))
    if me > 0:
        ops.append(dist.P2POp(dist.irecv, from_prev, peer(me - 1), group))
    if me + 1 < n:
        ops.append(dist.P2POp(dist.irecv, from_next, peer(me + 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_prev, block, from_next])


def partition_pois_z(table: poi_mod.POITable3D, n_blocks: int, dim_z: int):
    """Assign each POI to the z-block that holds it and pad every block's
    queue to the largest count, replicating the block's first POI (the
    padding is poisoned before it computes).  Returns (idx [n_blocks, cap]
    int64 into the queue, valid [n_blocks, cap], owner [N], bz).  Reads
    ``table.z`` on the host once."""
    z = table.coords_numpy()[2]
    bz = dim_z // n_blocks
    owner = np.clip((z // bz).astype(np.int64), 0, n_blocks - 1)
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n_blocks)
    cap = int(counts.max()) if len(order) else 1

    idx = np.zeros((n_blocks, cap), np.int64)
    valid = np.zeros((n_blocks, cap), bool)
    pos = 0
    for b in range(n_blocks):
        c = counts[b]
        idx[b, :c] = order[pos: pos + c]
        idx[b, c:] = order[pos] if c else 0
        valid[b, :c] = True
        pos += c
    return idx, valid, owner, bz


def prepare_blocks(ref_ext: torch.Tensor, tar_ext: torch.Tensor, halo: int,
                   first: bool, last: bool):
    """The three gradients of an extended reference block and the
    coefficients of its extended target block: (gx, gy, gz, coeff).
    ``gradient_z`` of the whole volume leaves 2-voxel zero borders at the
    volume's z faces (oc_gradient.cpp:143); the ``first`` and ``last``
    blocks get them back, where the clamp-filled halo would give a
    non-zero stencil."""
    bz = ref_ext.shape[0] - 2 * halo
    gx = gradient.gradient_x_3d(ref_ext).contiguous()
    gy = gradient.gradient_y_3d(ref_ext).contiguous()
    gz = gradient.gradient_z_3d(ref_ext)
    if first:
        gz[halo:halo + 2] = 0.0
    if last:
        gz[halo + bz - 2:halo + bz] = 0.0
    coeff = bspline.tricubic_prepare(tar_ext).contiguous()
    return gx, gy, gz.contiguous(), coeff


def scatter_back(table: poi_mod.POITable3D, refined: torch.Tensor,
                 idx: torch.Tensor, valid: torch.Tensor, *, rz: int,
                 dim_z: int) -> poi_mod.POITable3D:
    """Every block's results ``refined`` [n_blocks, cap, 17] (p, u0, v0,
    w0, zncc, iteration) written to their POIs in queue order, then the
    reference's global z-edge guard (oc_icgn.cpp:1279) imposed again: a
    POI whose subset crosses the volume's z faces keeps its deformation
    and reads -3, unless it already carried a failure code.  The padding
    rows go to a row past the end, which is dropped."""
    n = table.n
    tgt = torch.where(valid.reshape(-1), idx.reshape(-1),
                      torch.full((), n, dtype=idx.dtype, device=idx.device))
    buf = torch.cat([torch.cat([table.p, table.r[:, [
        poi_mod.R3_U0, poi_mod.R3_V0, poi_mod.R3_W0, poi_mod.R3_ZNCC,
        poi_mod.R3_ITER]]], 1), refined.new_zeros((1, _REFINED))])
    buf[tgt] = refined.reshape(-1, _REFINED)
    p_new = buf[:n, :12]
    r_new = table.r.clone()
    for j, col in enumerate((poi_mod.R3_U0, poi_mod.R3_V0, poi_mod.R3_W0,
                             poi_mod.R3_ZNCC, poi_mod.R3_ITER)):
        r_new[:, col] = buf[:n, 12 + j]
    z = table.z
    bad = (z - rz < 0) | (z + rz > dim_z - 1)
    zncc_in = table.r[:, poi_mod.R3_ZNCC]
    r_new[:, poi_mod.R3_ZNCC] = torch.where(
        bad, torch.where(zncc_in >= 0, torch.full_like(zncc_in, -3.0),
                         zncc_in), r_new[:, poi_mod.R3_ZNCC])
    p_new = torch.where(bad[:, None], table.p, p_new)
    return table.replace(p=p_new, r=r_new)


class ShardedICGN3D1:
    """DVC IC-GN over a z-sharded volume (multi-GPU DVC).

    Usage mirrors ICGN3D1, but ``compute`` takes the mesh (``make_mesh(...,
    axis="z")``, one rank per device).  The volume's z size must divide
    by the mesh's.  Every rank holds the whole table and both host
    volumes, uploads only its z-block (at the volumes' native width, cast
    to float32 on the device), refines the POIs of its block, and ends with
    the whole refined table.

    ``window_margin`` and ``eval_mode`` ("lattice" or "tile") select the
    windowed eval as in ICGN3D1.  The
    halo, rz + max(9, margin + 1), keeps a POI's coefficient window inside
    the extended block for seeds within about 1 voxel of the block's edge;
    larger seeds read edge-clipped windows as the single-device module
    does at the volume's faces, and real window exits fail -3.  Chunks
    follow ``ICGN3D1.auto_chunk`` of a block's queue, every chunk padded to
    that length.  As in the JAX package, the refined table carries p,
    u0, v0, w0, zncc and the iteration count; the convergence column and
    the subset radii keep the values the table came with.  ``stats``
    counts what ICGN3D1's does; ``times`` holds the seconds of the last
    compute's stages (the two halo exchanges, the gradients and
    coefficients, the refine, the gather), each
    closed by a device synchronisation."""

    def __init__(self, subset_radius_x: int, subset_radius_y: int,
                 subset_radius_z: int, conv_criterion: float = 0.001,
                 stop_condition: float = 10,
                 window_margin: Optional[int] = 8,
                 eval_mode: str = "lattice"):
        self.rx = int(subset_radius_x)
        self.ry = int(subset_radius_y)
        self.rz = int(subset_radius_z)
        self.conv_criterion = float(conv_criterion)
        self.stop_condition = float(stop_condition)
        self.window_margin = window_margin
        self.eval_mode = eval_mode
        # rz + 2 covers the gradient stencil, +7 the prefilter taps;
        # rz + margin + 1 fits seeded windows
        margin = 0 if window_margin is None else int(window_margin)
        self.halo = self.rz + max(2 + 7, margin + 1)
        self.ref_vol = None
        self.tar_vol = None
        self.stats = collections.Counter()
        self.times = {}

    def set_images(self, ref_vol, tar_vol) -> None:
        """Host volumes [Z, Y, X] (Image3D or arrays); integer volumes keep
        their width until they reach the device."""
        def host(v):
            a = np.asarray(getattr(v, "mat", v))
            return a if np.issubdtype(a.dtype, np.integer) else a.astype(
                np.float32)

        self.ref_vol = host(ref_vol)
        self.tar_vol = host(tar_vol)

    def _margin(self, n_dev: int) -> Optional[int]:
        """ICGN3D1's window rule (``base.eval_margin``) on a rank's
        halo-extended block of a mesh of ``n_dev``."""
        dim_z, dim_y, dim_x = self.ref_vol.shape
        return base.eval_margin(
            self.window_margin, (self.rx, self.ry, self.rz),
            (dim_x, dim_y, dim_z // n_dev + 2 * self.halo))

    def compute(self, table: poi_mod.POITable3D, mesh: DeviceMesh,
                axis: str = "z") -> poi_mod.POITable3D:
        group = mesh.get_group(axis)
        n_dev = dist.get_world_size(group)
        me = dist.get_rank(group)
        dev = mesh_device(mesh)
        if table.device != dev:
            raise ValueError(f"POI table on {table.device}, mesh on {dev}")
        dim_z = self.ref_vol.shape[0]
        if dim_z % n_dev:
            raise ValueError(
                f"volume z={dim_z} not divisible by mesh size {n_dev}")
        if dim_z // n_dev < self.halo:
            raise ValueError("block smaller than halo; use fewer devices")
        margin = self._margin(n_dev)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        idx, valid, _, bz = partition_pois_z(table, n_dev, dim_z)
        cut = slice(me * bz, (me + 1) * bz)
        ref_blk = base.upload(self.ref_vol[cut], dev)
        tar_blk = base.upload(self.tar_vol[cut], dev)
        sync()
        t0 = time.perf_counter()
        ref_ext = halo_exchange_z(ref_blk, self.halo, mesh, axis)
        tar_ext = halo_exchange_z(tar_blk, self.halo, mesh, axis)
        del ref_blk, tar_blk
        sync()
        t_halo = time.perf_counter()
        gx, gy, gz, coeff = prepare_blocks(ref_ext, tar_ext, self.halo,
                                           me == 0, me == n_dev - 1)
        del tar_ext
        sync()
        t1 = time.perf_counter()

        cap = idx.shape[1]
        chunk = ICGN3D1(self.rx, self.ry, self.rz,
                        device=dev).auto_chunk(cap)
        pad = -cap % chunk
        if pad:
            idx = np.pad(idx, ((0, 0), (0, pad)))
            valid = np.pad(valid, ((0, 0), (0, pad)))
        idx_d = torch.from_numpy(idx).to(dev)
        valid_d = torch.from_numpy(valid).to(dev)
        # a warp past the volume's z faces fails -3 as the global range
        # guard [1, dim-2) would, instead of reading the clamp-filled halo
        z_lo = self.halo + 1.0 if me == 0 else -float("inf")
        z_hi = self.halo + bz - 2.0 if me == n_dev - 1 else float("inf")
        zeta = poi_mod.R3_ZNCC
        parts = []
        for lo in range(0, idx.shape[1], chunk):
            rows = idx_d[me, lo:lo + chunk]
            ok = valid_d[me, lo:lo + chunk]
            zs = table.z[rows] - float(me * bz) + float(self.halo)
            zncc_in = torch.where(ok, table.r[rows, zeta],
                                  torch.full((), -10.0, device=dev))
            p_out, u0, v0, w0, zncc, it, _, _ = icgn_ops.icgn3d1(
                gx, gy, gz, ref_ext, coeff, table.x[rows], table.y[rows],
                zs, table.p[rows], zncc_in, self.conv_criterion,
                self.stop_condition, rx=self.rx, ry=self.ry, rz=self.rz,
                window_margin=margin, eval_mode=self.eval_mode,
                z_guard_lo=z_lo, z_guard_hi=z_hi, stats=self.stats)
            parts.append(torch.cat([p_out, torch.stack(
                [u0, v0, w0, zncc, it], 1)], 1))
            self.stats["chunks"] += 1
        mine = torch.cat(parts).contiguous()
        sync()
        t2 = time.perf_counter()

        everyone = [torch.empty_like(mine) for _ in range(n_dev)]
        dist.all_gather(everyone, mine, group=group)
        out = scatter_back(table, torch.stack(everyone), idx_d, valid_d,
                           rz=self.rz, dim_z=dim_z)
        sync()
        t3 = time.perf_counter()
        self.times = {"halo_exchange_s": t_halo - t0,
                      "prepare_s": t1 - t_halo, "refine_s": t2 - t1,
                      "gather_s": t3 - t2}
        return out
