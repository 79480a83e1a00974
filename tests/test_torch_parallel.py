"""The port's multi-GPU layer against the JAX package on the CPU.

* ``icgn3d1``'s z guards against the JAX ``icgn3d1`` with the same guards:
  codes equal, u/v/w within 2e-5 voxel; guards of +-inf bit-equal to none.
* ``partition_pois_z`` equal to the JAX package's.
* ``halo_exchange_z`` on 4 gloo ranks bit-equal to the JAX one under
  ``shard_map`` on 4 virtual devices (inner blocks included).
* ``ShardedICGN3D1`` at 1, 2 and 4 gloo ranks against the JAX
  ``ShardedICGN3D1`` on ``make_mesh(1/2/4, axis="z")``, for the four cases
  of ``tests/test_halo.py``: codes equal, u/v/w within 2e-5 voxel, every
  rank holding the same whole table.  At one rank it also matches the
  port's ``ICGN3D1`` within 1e-5 voxel, codes equal.
* The POI-axis helpers: a 2-rank sharded FFTCC2D -> ICGN2D1 equals the
  single run (``tests/test_parallel.py``), and ``replicate`` broadcasts
  rank 0's values.

The ranks are subprocesses of this file (``python
tests/test_torch_parallel.py --worker WORLD RANK PORT INPUTS OUT``), one
spawn of every world size for the whole file, on free local ports; they
import no jax.  The 1-rank worker lets ``make_mesh`` make its own group of
one; the others find torchrun's environment variables.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import opencorr_tpu_torch as ot  # noqa: E402
from opencorr_tpu_torch.parallel import halo as thalo  # noqa: E402
from opencorr_tpu_torch.parallel import mesh as tmesh  # noqa: E402

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"
WORLDS = (1, 2, 4)
R = 3  # the subset radius of tests/test_halo.py's cases
CASES = ("matches_single", "edge_blocks", "global_guard", "lattice_fallback")
# the cases and mesh sizes ShardedICGN3D1(eval_mode="tile") runs at
TILE_CASES = ("matches_single", "edge_blocks")
TILE_WORLDS = (1, 2)
CONV = {"global_guard": 0.01}
HALO_TEST = 5  # the slab depth of the halo-exchange comparison
TIMEOUT_S = 240


def make_speckle(shape, sigma=2.0, seed=0, scale=50.0, offset=128.0):
    """tests/conftest.py's speckle field."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.standard_normal(shape).astype(np.float32),
                          sigma)
    return (img * scale + offset).astype(np.float32)


def pair_3d():
    """tests/conftest.py's ``speckle_pair_3d``: a 48^3 volume and its
    target under (u, v, w) = (1.4, -0.7, 0.9)."""
    from scipy.ndimage import shift as ndshift

    d = 48
    base = make_speckle((d + 20,) * 3, sigma=1.5, seed=2)
    tu, tv, tw = 1.4, -0.7, 0.9
    ref = base[10:10 + d, 10:10 + d, 10:10 + d]
    tar = ndshift(base, (tw, tv, tu), order=3)[10:10 + d, 10:10 + d,
                                               10:10 + d]
    return np.ascontiguousarray(ref), np.ascontiguousarray(tar), (tu, tv, tw)


def pair_2d():
    """tests/conftest.py's ``speckle_pair_2d``."""
    from scipy.ndimage import shift as ndshift

    h, w = 160, 180
    base = make_speckle((h + 40, w + 40), sigma=2.0, seed=1)
    ref = base[20:20 + h, 20:20 + w]
    tar = ndshift(base, (-1.6, 2.3), order=3)[20:20 + h, 20:20 + w]
    return np.ascontiguousarray(ref), np.ascontiguousarray(tar)


def halo_volume():
    return np.arange(48 * 5 * 6, dtype=np.float32).reshape(48, 5, 6)


def case_inputs():
    """The four cases' input tables (x, y, z, p, r) as numpy arrays, the
    seeds of the first and third from the port's FFTCC3D(6, 6, 6) (equal
    to the JAX package's, tests/test_torch_dvc_pipeline.py)."""
    ref, tar, (tu, tv, tw) = pair_3d()
    f = ot.FFTCC3D(6, 6, 6, device=CPU)
    f.set_images(ref, tar)
    seeds = np.zeros(12, np.float32)
    seeds[[0, 4, 8]] = round(tu), round(tv), round(tw)
    out = {}
    for name, table, seeded in (
            ("matches_single", ot.poi_grid_3d((14, 14, 14), 3, 3, 3, 7,
                                              device=CPU), True),
            ("edge_blocks", ot.new_table_3d([12.0, 36.0, 12.0],
                                            [12.0, 36.0, 12.0],
                                            [4.0, 41.0, 4.0], device=CPU),
             False),
            ("global_guard", ot.new_table_3d([20.0, 20.0], [20.0, 20.0],
                                             [1.0, 24.0], device=CPU), True),
            ("lattice_fallback", ot.new_table_3d([20.0, 24.0], [20.0, 24.0],
                                                 [20.0, 28.0], device=CPU),
             False)):
        t = ot.table_to_numpy(f.compute(table) if seeded else table)
        if not seeded:
            t["p"][:] = seeds
        if name == "lattice_fallback":
            t["p"][0, 1] = 0.6  # uxx: a lattice deviation of 1.8 > D=1
        for k in ("x", "y", "z", "p", "r"):
            out[f"{name}/{k}"] = t[k]
    return out


def _table(inputs, name, device=CPU):
    g = lambda k: inputs[f"{name}/{k}"]
    n = len(g("x"))
    return ot.table_from_numpy_3d(
        g("x"), g("y"), g("z"), g("p"), g("r"), np.zeros((n, 6), np.float32),
        np.zeros((n, 3), np.float32), device=device)


# --- the ranks ---------------------------------------------------------------


def worker(world, rank, port, inputs_path, out_dir):
    """One rank: every case through the port's ShardedICGN3D1, the halo
    exchange of ``halo_volume``, and at 2 ranks the POI-axis helpers; its
    tables and blocks to ``out_dir/rank<rank>.npz``."""
    import torch.distributed as dist

    if world > 1:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    mesh = tmesh.make_mesh(world, axis="z", device=CPU)
    inputs = dict(np.load(inputs_path))
    ref, tar, _ = pair_3d()
    out = {}
    for name in CASES:
        conv = CONV.get(name, 0.001)
        m = thalo.ShardedICGN3D1(R, R, R, conv, 10)
        m.set_images(ref, tar)
        got = m.compute(_table(inputs, name), mesh)
        out[f"{name}/p"] = got.p.numpy()
        out[f"{name}/r"] = got.r.numpy()
        out[f"{name}/lattice"] = m.stats["lattice"]
        out[f"{name}/fallback"] = m.stats["fallback"]
        if world == 1:
            single = ot.ICGN3D1(R, R, R, conv, 10, device=CPU)
            single.set_images(ref, tar)
            single.prepare()
            one = single.compute(_table(inputs, name))
            out[f"{name}/single_p"] = one.p.numpy()
            out[f"{name}/single_r"] = one.r.numpy()
    if world in TILE_WORLDS:
        for name in TILE_CASES:
            m = thalo.ShardedICGN3D1(R, R, R, CONV.get(name, 0.001), 10,
                                     eval_mode="tile")
            m.set_images(ref, tar)
            got = m.compute(_table(inputs, name), mesh)
            out[f"tile/{name}/p"] = got.p.numpy()
            out[f"tile/{name}/r"] = got.r.numpy()
            out[f"tile/{name}/lattice"] = m.stats["lattice"]
    vol = torch.from_numpy(halo_volume())
    bz = vol.shape[0] // world
    out["halo_ext"] = thalo.halo_exchange_z(
        vol[rank * bz:(rank + 1) * bz], HALO_TEST, mesh).numpy()
    if world == 2:
        poi_mesh = tmesh.make_mesh(2, axis="poi", device=CPU)
        ref2, tar2 = pair_2d()
        f = ot.FFTCC2D(10, 10, device=CPU)
        f.set_images(ref2, tar2)
        icgn = ot.ICGN2D1(10, 10, 0.001, 10, device=CPU)
        icgn.set_images(ref2, tar2)
        icgn.prepare()
        pois = ot.poi_grid_2d((30, 30), 9, 7, 12, device=CPU)  # 63 POIs
        base = icgn.compute(f.compute(pois))
        padded, n = tmesh.pad_to_multiple(pois, 2)
        mine = tmesh.shard_table(padded, poi_mesh)
        done = icgn.compute(f.compute(mine))
        whole = tmesh.unpad(tmesh.gather_table(done, poi_mesh), n)
        out.update(poi_base_p=base.p.numpy(), poi_base_r=base.r.numpy(),
                   poi_shard_n=mine.n, poi_p=whole.p.numpy(),
                   poi_r=whole.r.numpy(), poi_x=whole.x.numpy(),
                   replicated=tmesh.replicate(
                       torch.full((3,), float(rank + 7)), poi_mesh).numpy())
    out["jax_loaded"] = any(m == "jax" or m.startswith(("jax.",
                                                        "opencorr_tpu."))
                            or m == "opencorr_tpu" for m in sys.modules)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


# --- the tests -----------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(world, inputs_path, out_dir):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(world),
         str(rank), str(port), inputs_path, out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
        text=True) for rank in range(world)]


def _jax_table(oc, jnp, inputs, name):
    g = lambda k: inputs[f"{name}/{k}"]
    return oc.new_table_3d(g("x"), g("y"), g("z")).replace(
        p=jnp.asarray(g("p")), r=jnp.asarray(g("r")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world size's ranks, started together, while the JAX package
    computes the same cases here; rank outputs and JAX tables."""
    import jax
    import jax.numpy as jnp

    import opencorr_tpu as oc
    from opencorr_tpu.parallel import halo as jhalo
    from opencorr_tpu.parallel import mesh as jmesh

    root = tmp_path_factory.mktemp("ranks")
    inputs = case_inputs()
    inputs_path = str(root / "inputs.npz")
    np.savez(inputs_path, **inputs)
    procs = {}
    for w in WORLDS:
        os.makedirs(root / f"w{w}")
        procs[w] = _spawn(w, inputs_path, str(root / f"w{w}"))
    try:
        ref, tar, _ = pair_3d()
        want = {}
        for w in WORLDS:
            mesh = jmesh.make_mesh(w, axis="z")
            for name in CASES:
                m = jhalo.ShardedICGN3D1(R, R, R, CONV.get(name, 0.001), 10)
                m.set_images(ref, tar)
                t = m.compute(_jax_table(oc, jnp, inputs, name), mesh)
                want[w, name] = (np.asarray(t.p), np.asarray(t.r))
            if w in TILE_WORLDS:
                for name in TILE_CASES:
                    m = jhalo.ShardedICGN3D1(R, R, R, CONV.get(name, 0.001),
                                             10, eval_mode="tile")
                    m.set_images(ref, tar)
                    t = m.compute(_jax_table(oc, jnp, inputs, name), mesh)
                    want[w, "tile", name] = (np.asarray(t.p),
                                             np.asarray(t.r))
        fn = jax.shard_map(
            lambda b: jhalo.halo_exchange_z(b, HALO_TEST, "z")[None],
            mesh=jmesh.make_mesh(4, axis="z"),
            in_specs=jax.sharding.PartitionSpec("z"),
            out_specs=jax.sharding.PartitionSpec("z"), check_vma=False)
        want["halo"] = np.asarray(fn(jnp.asarray(halo_volume())))
        logs = {}
        for w, ps in procs.items():
            logs[w] = [p.communicate(timeout=TIMEOUT_S)[0] for p in ps]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    got = {}
    for w, ps in procs.items():
        for rank, p in enumerate(ps):
            assert p.returncode == 0, f"world {w} rank {rank}:\n" \
                                      f"{logs[w][rank]}"
            got[w, rank] = dict(np.load(root / f"w{w}" / f"rank{rank}.npz"))
    return dict(got=got, want=want, inputs=inputs)


def _codes_equal(r, r_want):
    zt, zw = r[:, 3], r_want[:, 3]
    np.testing.assert_array_equal(np.where(zt < 0, zt, 1),
                                  np.where(zw < 0, zw, 1))


def _duvw(p, p_want):
    return np.abs(p[:, [0, 4, 8]] - p_want[:, [0, 4, 8]])


def _replay(inputs, name):
    """The global icgn3d1 of the case in float64 (the reference replay)."""
    from opencorr_tpu_torch.ops import bspline as tbs
    from opencorr_tpu_torch.ops import gradient as tgrad
    from opencorr_tpu_torch.ops import icgn as ticgn

    ref, tar, _ = pair_3d()
    d = lambda a: torch.from_numpy(np.asarray(a, np.float64).copy())
    g = lambda k: inputs[f"{name}/{k}"]
    tr = d(ref)
    return ticgn.icgn3d1(
        *(getattr(tgrad, f"gradient_{a}_3d")(tr) for a in "xyz"), tr,
        tbs.tricubic_prepare(d(tar)), d(g("x")), d(g("y")), d(g("z")),
        d(g("p")), d(g("r")[:, 3]), CONV.get(name, 0.001), 10.0, rx=R, ry=R,
        rz=R, window_margin=8)[0].numpy()


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_icgn3d1_matches_jax(runs, world, name):
    """The port's ShardedICGN3D1 against the JAX package's at the same mesh
    size: codes, u0/v0/w0 and iteration counts equal, zncc within 1e-5,
    u/v/w within 2e-5 voxel at the median and 6e-5 at the worst, and the
    same table on every rank.  The 12x12 Gauss-Newton solve of an r=3
    subset (343 voxels) amplifies float32 rounding: on these cases the JAX
    package's single-device ICGN3D1 lies up to 5.6e-5 voxel from a float64
    replay, the port's up to 1.1e-5 (test_sharded_one_rank_matches_
    icgn3d1 holds the port to the replay)."""
    p_want, r_want = runs["want"][world, name]
    ranks = [runs["got"][world, k] for k in range(world)]
    p, r = ranks[0][f"{name}/p"], ranks[0][f"{name}/r"]
    _codes_equal(r, r_want)
    d = _duvw(p, p_want)
    assert np.median(d) <= 2e-5 and d.max() <= 6e-5, (np.median(d), d.max())
    np.testing.assert_array_equal(r[:, [0, 1, 2, 4]], r_want[:, [0, 1, 2, 4]])
    np.testing.assert_allclose(r[:, 3], r_want[:, 3], rtol=0, atol=1e-5)
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[f"{name}/p"], p)
        np.testing.assert_array_equal(other[f"{name}/r"], r)
    assert not any(bool(rk["jax_loaded"]) for rk in ranks)
    # the cases' own checks (tests/test_halo.py)
    zncc = r[:, 3]
    if name == "matches_single":
        assert (zncc > 0).mean() > 0.8
    if name == "edge_blocks":
        assert (zncc > 0).all()
    if name == "global_guard":
        assert zncc[0] == -3.0 and zncc[1] > 0
    if name == "lattice_fallback":
        assert sum(rk[f"{name}/fallback"] for rk in ranks) > 0


@pytest.mark.parametrize("name", TILE_CASES)
@pytest.mark.parametrize("world", TILE_WORLDS)
def test_sharded_tile_matches_jax(runs, world, name):
    """ShardedICGN3D1(eval_mode="tile") against the JAX package's tile
    path at the same mesh size, with the lattice cases' gate: codes,
    u0/v0/w0 and iteration counts equal, u/v/w within 2e-5 voxel at the
    median and 6e-5 at the worst; no lattice launch; every rank holds the
    same table."""
    p_want, r_want = runs["want"][world, "tile", name]
    ranks = [runs["got"][world, k] for k in range(world)]
    p, r = ranks[0][f"tile/{name}/p"], ranks[0][f"tile/{name}/r"]
    _codes_equal(r, r_want)
    d = _duvw(p, p_want)
    assert np.median(d) <= 2e-5 and d.max() <= 6e-5, (np.median(d), d.max())
    np.testing.assert_array_equal(r[:, [0, 1, 2, 4]], r_want[:, [0, 1, 2, 4]])
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[f"tile/{name}/p"], p)
    assert all(int(rk[f"tile/{name}/lattice"]) == 0 for rk in ranks)
    assert (r[:, 3] > 0).mean() > 0.8


@pytest.mark.parametrize("name", CASES)
def test_sharded_one_rank_matches_icgn3d1(runs, name):
    """At one rank the extended block is the volume plus clamp-filled slabs
    deeper than the prefilter's 7 taps, so the sharded result is the
    single-device module's: codes equal, u/v/w within 1e-5 voxel; and
    within 1.5e-5 of the float64 replay of the global icgn3d1."""
    rk = runs["got"][1, 0]
    p, r = rk[f"{name}/p"], rk[f"{name}/r"]
    _codes_equal(r, rk[f"{name}/single_r"])
    assert _duvw(p, rk[f"{name}/single_p"]).max() <= 1e-5
    ok = r[:, 3] > 0
    assert _duvw(p, _replay(runs["inputs"], name))[ok].max() <= 1.5e-5


def test_halo_exchange_matches_jax(runs):
    """Four ranks, two of them inner blocks: each extended block bit-equal
    to the JAX package's under shard_map."""
    want = runs["want"]["halo"]
    for rank in range(4):
        got = runs["got"][4, rank]["halo_ext"]
        assert got.shape == want[rank].shape
        np.testing.assert_array_equal(got, want[rank])


def test_poi_axis_sharding_matches_single(runs):
    """tests/test_parallel.py's sharded ICGN2D1 on 2 ranks: 63 POIs padded
    to 64, 32 a rank, gathered and unpadded; p within 1e-5, r within
    1e-4 of the single run on every rank."""
    for rank in range(2):
        rk = runs["got"][2, rank]
        assert int(rk["poi_shard_n"]) == 32
        assert rk["poi_p"].shape == (63, 12)
        np.testing.assert_allclose(rk["poi_p"], rk["poi_base_p"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(rk["poi_r"], rk["poi_base_r"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(rk["replicated"], np.full(3, 7.0))


def test_partition_pois_z_matches_jax():
    import opencorr_tpu as oc
    from opencorr_tpu.parallel import halo as jhalo

    rng = np.random.default_rng(3)
    z = rng.uniform(0, 96, 50).astype(np.float32)
    z[:3] = [0.0, 95.9, 47.99]
    xy = np.zeros(50, np.float32)
    for n_blocks in (1, 3, 4, 8):
        want = jhalo.partition_pois_z(oc.new_table_3d(xy, xy, z), n_blocks,
                                      96)
        got = thalo.partition_pois_z(ot.new_table_3d(xy, xy, z, device=CPU),
                                     n_blocks, 96)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # an empty block replicates index 0 and counts no valid row
    idx, valid, _, _ = thalo.partition_pois_z(
        ot.new_table_3d(xy[:2], xy[:2], np.float32([1.0, 2.0]), device=CPU),
        2, 96)
    assert valid[1].sum() == 0 and (idx[1] == 0).all()


def _guard_pair():
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(7)
    d, h, w = 48, 40, 44
    ref = (gaussian_filter(rng.standard_normal((d, h, w)), 1.6) * 55
           + 128).astype(np.float32)
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    tar = map_coordinates(ref, [zz - 0.4, yy + 0.25, xx - 0.6], order=3,
                          mode="nearest").astype(np.float32)
    n = 12
    xs = np.full(n, 21.0, np.float32)
    ys = np.full(n, 19.0, np.float32)
    zs = np.linspace(10, 37, n).astype(np.float32)
    return ref, tar, xs, ys, zs


def _icgn3d1_both(ref, tar, xs, ys, zs, margin, lo, hi):
    import jax.numpy as jnp

    from opencorr_tpu.ops import bspline as jbs
    from opencorr_tpu.ops import gradient as jgrad
    from opencorr_tpu.ops import icgn as jicgn
    from opencorr_tpu_torch.ops import bspline as tbs
    from opencorr_tpu_torch.ops import gradient as tgrad
    from opencorr_tpu_torch.ops import icgn as ticgn

    n, r = len(xs), 5
    p0 = np.zeros((n, 12), np.float32)
    z0 = np.zeros(n, np.float32)
    inf = np.float32(np.inf)
    jlo = -inf if lo is None else np.float32(lo)
    jhi = inf if hi is None else np.float32(hi)
    oj = jicgn.icgn3d1(
        *(getattr(jgrad, f"gradient_{a}_3d")(jnp.asarray(ref)) for a in "xyz"),
        jnp.asarray(ref), jbs.tricubic_prepare(jnp.asarray(tar)),
        *map(jnp.asarray, (xs, ys, zs, p0, z0)), jnp.float32(0.001),
        jnp.float32(10), rx=r, ry=r, rz=r, window_margin=margin,
        eval_mode="lattice", z_guard_lo=jnp.float32(jlo),
        z_guard_hi=jnp.float32(jhi))
    tref = torch.from_numpy(ref)
    targs = (*(getattr(tgrad, f"gradient_{a}_3d")(tref) for a in "xyz"),
             tref, tbs.tricubic_prepare(torch.from_numpy(tar)),
             *(torch.from_numpy(a.copy()) for a in (xs, ys, zs, p0, z0)),
             0.001, 10.0)
    kw = dict(rx=r, ry=r, rz=r, window_margin=margin)
    ot_ = ticgn.icgn3d1(*targs, **kw, z_guard_lo=lo, z_guard_hi=hi)
    return ([np.asarray(a) for a in oj], [a.numpy() for a in ot_], targs, kw)


@pytest.mark.parametrize("margin", [8, None])
@pytest.mark.parametrize("lo,hi", [(14.5, 33.5), (14.5, None),
                                   (None, 33.5)])
def test_icgn3d1_z_guards_match_jax(margin, lo, hi):
    """POIs along z whose warped subsets cross the guards fail -3 in both
    packages; the others refine as without guards: codes equal, iteration
    counts equal, u/v/w within 2e-5 voxel."""
    from opencorr_tpu_torch.ops import icgn as ticgn

    ref, tar, xs, ys, zs = _guard_pair()
    oj, ot_, targs, kw = _icgn3d1_both(ref, tar, xs, ys, zs, margin, lo, hi)
    zj, zt = oj[4], ot_[4]
    np.testing.assert_array_equal(np.where(zt < 0, zt, 1),
                                  np.where(zj < 0, zj, 1))
    np.testing.assert_array_equal(ot_[7], oj[7])
    np.testing.assert_array_equal(ot_[5], oj[5])
    np.testing.assert_allclose(ot_[0][:, [0, 4, 8]], oj[0][:, [0, 4, 8]],
                               rtol=0, atol=2e-5)
    guarded = zt == -3.0
    assert guarded.any() and (zt > 0.99).sum() >= 3
    # the guards fail only POIs that converge without them
    plain = ticgn.icgn3d1(*targs, **kw)[4].numpy()
    np.testing.assert_array_equal(zt > 0, (plain > 0) & ~guarded)


@pytest.mark.parametrize("margin", [8, None])
def test_icgn3d1_infinite_guards_equal_none(margin):
    """Guards of -inf and +inf turn both sides off: bit-equal outputs to
    guards None."""
    from opencorr_tpu_torch.ops import icgn as ticgn

    ref, tar, xs, ys, zs = _guard_pair()
    _, _, targs, kw = _icgn3d1_both(ref, tar, xs[:4], ys[:4], zs[:4], margin,
                                    None, None)
    none = ticgn.icgn3d1(*targs, **kw)
    inf = ticgn.icgn3d1(*targs, **kw, z_guard_lo=-float("inf"),
                        z_guard_hi=float("inf"))
    for a, b in zip(none, inf):
        assert torch.equal(a, b)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    w_, r_, port_, inp_, out_ = sys.argv[2:7]
    worker(int(w_), int(r_), int(port_), inp_, out_)
