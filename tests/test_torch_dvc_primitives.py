"""The port's DVC building blocks against the JAX package on the CPU: the 3D
POI table and its carry-across, Image3D, the 3D tables and matrix
checkpoint, the 3D gradients, the tricubic prefilter and eval, the 3D
warps, the 4x4 and 12x12 inverses, fftcc3d and the 3D strain.

Inputs are made with numpy from a seed and handed to both packages.
Gradients, prefilter, tricubic eval, warps and inverses agree within
1e-6 relative; fftcc3d's integer displacements are equal and its zncc
within 1e-5; the strain within 1e-5."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu.data import poi as jpoi
from opencorr_tpu.io import table as jtable
from opencorr_tpu.ops import bspline as jbs
from opencorr_tpu.ops import fftcc as jfftcc
from opencorr_tpu.ops import gradient as jgrad
from opencorr_tpu.ops import linalg as jlinalg
from opencorr_tpu.ops import warp as jwarp
from opencorr_tpu_torch.data import poi as tpoi
from opencorr_tpu_torch.ops import bspline as tbs
from opencorr_tpu_torch.ops import fftcc as tfftcc
from opencorr_tpu_torch.ops import gradient as tgrad
from opencorr_tpu_torch.ops import linalg as tlinalg
from opencorr_tpu_torch.ops import warp as twarp

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"
FIELDS_3D = ("x", "y", "z", "p", "r", "e", "sr")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _filled_jax_table_3d(n=20, seed=0):
    """A JAX DVC table with every field holding distinct values."""
    rng = np.random.default_rng(seed)
    t = oc.new_table_3d(rng.uniform(10, 90, n), rng.uniform(10, 70, n),
                        rng.uniform(5, 40, n))
    return t.replace(
        p=jnp.asarray(rng.normal(size=(n, 12)), jnp.float32),
        r=jnp.asarray(rng.normal(size=(n, 7)), jnp.float32),
        e=jnp.asarray(rng.normal(size=(n, 6)) * 1e-3, jnp.float32),
        sr=jnp.asarray(rng.integers(5, 20, (n, 3)), jnp.float32))


def _to_port_3d(tj):
    return ot.table_from_numpy_3d(*(np.asarray(getattr(tj, f))
                                    for f in FIELDS_3D), device=CPU)


# --- tables, volumes and files ---------------------------------------------

def test_field_indices_3d_match_jax():
    names = ("U3", "UX3", "UY3", "UZ3", "V3", "VX3", "VY3", "VZ3", "W3",
             "WX3", "WY3", "WZ3", "R3_U0", "R3_V0", "R3_W0", "R3_ZNCC",
             "R3_ITER", "R3_CONV", "R3_FEAT")
    assert [getattr(tpoi, k) for k in names] == [getattr(jpoi, k)
                                                  for k in names]


@pytest.mark.parametrize("args", [((35, 35, 60), 7, 7, 117, 5),
                                  ((3.5, 4.0, 2.0), 3, 4, 2, 2)])
def test_poi_grid_3d_matches_jax(args):
    tj = oc.poi_grid_3d(*args)
    tt = ot.poi_grid_3d(*args, device=CPU)
    assert isinstance(tt, ot.POITable3D) and tt.n == tj.n
    back = ot.table_to_numpy(tt)
    for f in FIELDS_3D:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(tj, f)))
    # x fastest, then y, then z
    assert tt.x[1] - tt.x[0] == args[4] and tt.y[1] == tt.y[0]
    assert tt.z[args[1] * args[2]] - tt.z[0] == args[4]


def test_table_3d_carry_across():
    """A JAX table enters the port unchanged and leaves it unchanged."""
    tj = _filled_jax_table_3d()
    tt = _to_port_3d(tj)
    back = ot.table_to_numpy(tt)
    assert set(back) == set(FIELDS_3D)
    for f in FIELDS_3D:
        assert back[f].dtype == np.float32
        np.testing.assert_array_equal(back[f], np.asarray(getattr(tj, f)))
    for prop in ("u", "v", "w", "zncc"):
        np.testing.assert_array_equal(getattr(tt, prop).numpy(),
                                      np.asarray(getattr(tj, prop)))
    n = tj.n
    with pytest.raises(ValueError, match="field r"):
        ot.table_from_numpy_3d(np.zeros(n), np.zeros(n), np.zeros(n),
                               np.zeros((n, 12)), np.zeros((n, 6)),
                               np.zeros((n, 6)), np.zeros((n, 3)),
                               device=CPU)


def test_new_table_3d_and_map():
    t = ot.new_table_3d([1, 2, 3], [4, 5, 6], [7, 8, 9], device=CPU)
    assert (t.p.shape, t.r.shape, t.e.shape, t.sr.shape) == (
        (3, 12), (3, 7), (3, 6), (3, 3))
    twice = t.map(lambda a: torch.cat([a, a]))
    assert isinstance(twice, ot.POITable3D) and twice.n == 6
    np.testing.assert_array_equal(twice.coords_numpy()[2], [7, 8, 9] * 2)


def _read(path):
    with open(path) as f:
        return f.read().splitlines()


def _parse(lines, skip=0):
    rows = [[float(v) for v in ln.rstrip(",").split(",")]
            for ln in lines[skip:] if ln]
    return np.asarray(rows, np.float64)


def test_save_table_3d_matches_jax(tmp_path):
    tj = _filled_jax_table_3d(seed=1)
    tt = _to_port_3d(tj)
    pj, pt = tmp_path / "jax.csv", tmp_path / "torch.csv"
    jtable.save_table_3d(str(pj), tj)
    ot.save_table_3d(str(pt), tt)
    lj, lt = _read(pj), _read(pt)
    assert lt[0] == lj[0] and len(lt[0].rstrip(",").split(",")) == 21
    assert len(lt) == tj.n + 1 and lt[1].endswith(",")
    np.testing.assert_array_equal(_parse(lt, 1), _parse(lj, 1))
    # both packages read the file back to the same table
    bj = jtable.load_table_3d(str(pt))
    bt = ot.load_table_3d(str(pt), device=CPU)
    for f in FIELDS_3D:
        np.testing.assert_allclose(getattr(bt, f).numpy(),
                                   np.asarray(getattr(bj, f)), rtol=0,
                                   atol=1e-7)


@pytest.mark.parametrize("variable", ["w", "zncc", "ezz", "iteration"])
def test_save_map_3d_matches_jax(tmp_path, variable):
    tj = oc.poi_grid_3d((1, 2, 1), 3, 2, 3, 2)
    rng = np.random.default_rng(4)
    tj = tj.replace(
        p=jnp.asarray(rng.normal(size=(tj.n, 12)), jnp.float32),
        r=jnp.asarray(rng.normal(size=(tj.n, 7)), jnp.float32),
        e=jnp.asarray(rng.normal(size=(tj.n, 6)), jnp.float32))
    tt = _to_port_3d(tj)
    pj, pt = tmp_path / "jax.csv", tmp_path / "torch.csv"
    dims = (8, 7, 6)
    jtable.save_map_3d(str(pj), tj, variable, dims)
    ot.save_map_3d(str(pt), tt, variable, dims)
    lj, lt = _read(pj), _read(pt)
    assert len(lt) == len(lj) == 6 * (7 + 1)
    np.testing.assert_array_equal(_parse(lt), _parse(lj))


def test_matrix_bin_3d_bytes_match_jax(tmp_path):
    tj = _filled_jax_table_3d(seed=2)
    tt = _to_port_3d(tj)
    pj, pt = tmp_path / "jax.bin", tmp_path / "torch.bin"
    dims = (100, 100, 700)
    jtable.save_matrix_bin_3d(str(pj), tj, dims)
    ot.save_matrix_bin_3d(str(pt), tt, dims)
    assert pt.read_bytes() == pj.read_bytes()
    rec, back_dims = ot.load_matrix_bin_3d(str(pt))
    assert back_dims == dims and rec.shape == (tj.n, 8)
    np.testing.assert_array_equal(rec, jtable.load_matrix_bin_3d(str(pj))[0])


def test_image3d_bin_and_tiff_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    vol = rng.uniform(0, 255, (5, 6, 7)).astype(np.float32)
    path = str(tmp_path / "vol.bin")
    ot.Image3D.from_array(vol).save_bin(path)
    with open(path, "rb") as f:
        assert np.fromfile(f, np.int32, 3).tolist() == [7, 6, 5]
    for img in (ot.Image3D.load(path), oc.Image3D.load(path)):
        np.testing.assert_array_equal(img.mat, vol)
    tj = str(tmp_path / "jax.bin")
    oc.Image3D.from_array(vol).save_bin(tj)
    assert open(tj, "rb").read() == open(path, "rb").read()
    im = ot.Image3D.load(path)
    assert (im.dim_x, im.dim_y, im.dim_z) == (7, 6, 5)

    cv2 = pytest.importorskip("cv2")
    pages = [np.round(p).astype(np.uint8) for p in vol]
    tif = str(tmp_path / "vol.tif")
    assert cv2.imwritemulti(tif, pages)
    got = ot.Image3D.load(tif).mat
    np.testing.assert_array_equal(got, oc.Image3D.load(tif).mat)
    assert got.shape == (5, 6, 7) and got.dtype == np.float32
    with pytest.raises(IOError):
        ot.Image3D.load(str(tmp_path / "vol.raw"))


def test_3d_modules_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ot.poi_grid_3d((5, 5, 5), 2, 2, 2, 3),
                 lambda: ot.FFTCC3D(8, 8, 8), lambda: ot.ICGN3D1(8, 8, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# --- gradients, B-splines, warps, inverses ---------------------------------

def _volume(shape=(20, 22, 24), seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, shape).astype(np.float32)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_gradient_3d_matches_jax(axis):
    vol = _volume()
    want = np.asarray(getattr(jgrad, f"gradient_{axis}_3d")(jnp.asarray(vol)))
    got = getattr(tgrad, f"gradient_{axis}_3d")(_t(vol)).numpy()
    assert got.shape == vol.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_prefilter_matches_jax():
    np.testing.assert_array_equal(tbs.BSPLINE_PREFILTER, jbs.BSPLINE_PREFILTER)
    vol = _volume((9, 17, 13), seed=1)  # an axis shorter than the stencil
    want = np.asarray(jbs.tricubic_prepare(jnp.asarray(vol)))
    got = tbs.tricubic_prepare(_t(vol)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("slab", [1 << 20, 700])
def test_tricubic_eval_matches_jax(slab):
    """In range, at the _below edge, out of range and NaN; the slabbed
    loop (slab 700 over 3,000 samples) gives the same values."""
    coeff = np.asarray(jbs.tricubic_prepare(jnp.asarray(_volume())))
    dz, dy, dx = coeff.shape
    rng = np.random.default_rng(2)
    pts = [rng.uniform(-0.5, d - 1.5, 3000).astype(np.float32)
           for d in (dx, dy, dz)]
    below = np.nextafter(np.float32(dx - 2), np.float32(0))
    pts[0][:4] = [1.0, below, dx - 2, 0.999]
    pts[1][5] = np.nan
    xs, ys, zs = pts
    vj, oj = jbs.tricubic_eval(jnp.asarray(coeff), jnp.asarray(xs),
                               jnp.asarray(ys), jnp.asarray(zs))
    vt, ot_ = tbs.tricubic_eval(_t(coeff), _t(xs), _t(ys), _t(zs), slab=slab)
    oj = np.asarray(oj)
    np.testing.assert_array_equal(ot_.numpy(), oj)
    assert oj[2] and oj[3] and oj[5] and not oj[0] and not oj[1]
    assert (vt.numpy()[oj] == -1.0).all()
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=1e-6 * np.abs(coeff).max())


def test_tricubic_interpolates_the_prefiltered_volume():
    """At integer voxels the spline reproduces a speckle volume (the point
    of the prefilter), away from the clamped edges, up to the 15-tap
    truncation of the exact prefilter (1e-4 of the grey range)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(5)
    vol = (gaussian_filter(rng.standard_normal((24, 24, 24)), 1.5) * 50
           + 128).astype(np.float32)
    coeff = tbs.tricubic_prepare(_t(vol))
    k = torch.arange(9, 15, dtype=torch.float32)
    zz, yy, xx = torch.meshgrid(k, k, k, indexing="ij")
    val, oob = tbs.tricubic_eval(coeff, xx, yy, zz)
    assert not oob.any()
    np.testing.assert_allclose(val.numpy(), vol[9:15, 9:15, 9:15], rtol=0,
                               atol=1e-4 * np.abs(vol).max())


def test_warp3d1_round_trip_matches_jax():
    rng = np.random.default_rng(6)
    p = (rng.normal(size=(9, 12)) * 0.1).astype(np.float32)
    wj = np.asarray(jwarp.warp3d1_from_p(jnp.asarray(p)))
    wt = twarp.warp3d1_from_p(_t(p)).numpy()
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(twarp.p_from_warp3d1(_t(wt)).numpy(),
                                  np.asarray(jwarp.p_from_warp3d1(
                                      jnp.asarray(wj))))
    np.testing.assert_allclose(twarp.p_from_warp3d1(_t(wt)).numpy(), p,
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("k", [4, 12])
def test_inv_small_3d_sizes_match_jax(k):
    """4x4 (the warp) and 12x12 (the DVC Hessian, SPD)."""
    rng = np.random.default_rng(k)
    if k == 4:
        a = np.eye(4) + rng.normal(size=(16, 4, 4)) * 0.05
        a[:, 3] = [0, 0, 0, 1]
    else:
        m = rng.normal(size=(16, 40, 12))
        a = np.einsum("nsi,nsj->nij", m, m)
    a = a.astype(np.float32)
    want = np.asarray(jlinalg.inv_small(jnp.asarray(a)))
    got = tlinalg.inv_small(_t(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    eye = np.einsum("nij,njk->nik", a.astype(np.float64), got)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(k), eye.shape),
                               atol=1e-4)


# --- fftcc3d ---------------------------------------------------------------

def _int_pair(seed=7, dims=(24, 24, 24)):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, dims).astype(np.float32)
    tar = np.roll(ref, (1, -2, 3), axis=(0, 1, 2)).astype(np.float32)
    tar += rng.integers(0, 3, dims).astype(np.float32)  # integral noise
    return ref, tar


def _int64_argmax(ref, tar, x, y, z, tx, r):
    """Brute-force circular int64 correlation argmax (first flat index) of
    the reference window at (x, y, z) and the target window at
    (tx, y, z)."""
    w = 2 * r
    ri = ref[z - r:z + r, y - r:y + r, x - r:x + r].astype(np.int64)
    ti = tar[z - r:z + r, y - r:y + r, tx - r:tx + r].astype(np.int64)
    best, best_idx = None, None
    for dz in range(w):
        for dy in range(w):
            for dx in range(w):
                s = int(np.sum(ri * np.roll(ti, (-dz, -dy, -dx),
                                            axis=(0, 1, 2))))
                if best is None or s > best:
                    best, best_idx = s, (dz * w + dy) * w + dx
    du, dv, dw = best_idx % w, (best_idx // w) % w, best_idx // (w * w)
    return tuple(d - w if d > r else d for d in (du, dv, dw))


def test_fftcc3d_matches_jax_and_int64_replay():
    """Integral volumes: u/v/w equal to the JAX package's and to the exact
    int64 argmax on every POI; zncc within 1e-5; invalid POIs keep their
    input."""
    ref, tar = _int_pair()
    r = 4
    rng = np.random.default_rng(8)
    n = 27
    xs = rng.integers(r, 24 - r, n).astype(np.float32)
    ys = rng.integers(r, 24 - r, n).astype(np.float32)
    zs = rng.integers(r, 24 - r, n).astype(np.float32)
    xs[0] = 2.0  # window off the volume: invalid
    u0 = rng.uniform(-0.4, 0.4, n).astype(np.float32)
    zero = np.zeros(n, np.float32)
    args = (ref, tar, xs, ys, zs, u0, zero, zero)
    out_j = [np.asarray(a) for a in jfftcc.fftcc3d(
        *map(jnp.asarray, args), rx=r, ry=r, rz=r)]
    out_t = [a.numpy() for a in tfftcc.fftcc3d(*map(_t, args), rx=r, ry=r,
                                               rz=r)]
    np.testing.assert_array_equal(out_t[4], out_j[4])
    assert not out_t[4][0] and out_t[4][1:].all()
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(out_t[3][1:], out_j[3][1:], rtol=0, atol=1e-5)
    assert out_t[0][0] == u0[0]
    for i in range(1, n):
        want = _int64_argmax(ref, tar, int(xs[i]), int(ys[i]), int(zs[i]),
                             int(xs[i] + u0[i]), r)
        got = (out_t[0][i] - u0[i], out_t[1][i], out_t[2][i])
        assert np.allclose(got, want), (i, got, want)


def test_fftcc3d_module_matches_jax(speckle_pair_3d):
    """FFTCC3D on a non-integral pair (the f32 argmax, no re-rank) and on
    its rounded copy (the re-rank), chunked, against the JAX module."""
    ref, tar, tu, tv, tw = speckle_pair_3d
    for a, b in ((ref, tar), (np.round(ref), np.round(tar))):
        tj = oc.poi_grid_3d((14, 14, 14), 3, 3, 3, 10)
        fj = oc.FFTCC3D(8, 8, 8, chunk_size=10)
        fj.set_images(a, b)
        oj = fj.compute(tj)
        ft = ot.FFTCC3D(8, 8, 8, chunk_size=10, device=CPU)
        ft.set_images(ot.Image3D.from_array(a), ot.Image3D.from_array(b))
        otn = ot.table_to_numpy(ft.compute(ot.poi_grid_3d(
            (14, 14, 14), 3, 3, 3, 10, device=CPU)))
        np.testing.assert_array_equal(otn["p"], np.asarray(oj.p))
        np.testing.assert_allclose(otn["r"], np.asarray(oj.r), rtol=0,
                                   atol=1e-5)
        assert (np.abs(otn["p"][:, tpoi.U3] - round(tu)) <= 1).all()
        assert ft.stats.get("rerank", 0) == (3 if a is not ref else 0)


@pytest.mark.parametrize("kind", ["random", "scattered", "tie", "negative",
                                  "cap", "half"])
def test_rerank3d_plain_matches_int64_brute_force(kind):
    """fftcc._rerank3d, the oracle of the CUDA re-rank: the 8 candidates'
    circular scores in int64 numpy and the first-max rule (largest score,
    smallest flat index on a tie) on chip_smoke's re-rank cases, where
    ties, negative products and values just inside the range guard
    occur."""
    import chip_smoke as cs

    n, shape = 6, (6, 8, 10)
    v = int(np.prod(shape))
    ref_w, tar_w, flat = cs.rerank3d_case(n, shape, kind, seed=3)
    ri, ti = (np.round(a).astype(np.int64) for a in (ref_w, tar_w))
    cand = torch.topk(_t(flat), 8, dim=1).indices.numpy()
    want, ties = [], 0
    for i in range(n):
        scores = []
        for c in cand[i]:
            cz, cy, cx = np.unravel_index(c, shape)
            scores.append(int(np.sum(ri[i] * np.roll(
                ti[i], (-cz, -cy, -cx), axis=(0, 1, 2)))))
        best = max(scores)
        top = [int(c) for c, s in zip(cand[i], scores) if s == best]
        ties += len(top) > 1
        want.append(min(top))
    got = tfftcc._rerank3d(_t(ri.reshape(n, v).astype(np.int32)),
                           _t(ti.reshape(n, v).astype(np.int32)), _t(flat),
                           *shape)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ties == (n if kind == "tie" else 0)
    if kind == "cap":
        cap = np.abs(ri).max(axis=(1, 2, 3)) * np.abs(ti).max(axis=(1, 2, 3))
        assert (v * (cap / 256.0 + 1.0) < 0.99 * 2.0 ** 31).all()
        assert (cap > 0.99 * 256 * (0.99 * 2.0 ** 31 / v - 1)).all()
    if kind == "negative":
        assert (ri < 0).any() and (ti < 0).any()


# --- strain ------------------------------------------------------------------

def _linear_field(x, y, z, rng):
    g = rng.normal(size=(3, 3)) * 2e-3
    p = np.zeros((x.shape[0], 12), np.float32)
    for row, col in enumerate((tpoi.U3, tpoi.V3, tpoi.W3)):
        p[:, col] = (g[row, 0] * x + g[row, 1] * y + g[row, 2] * z
                     + rng.normal(0, 0.01, x.shape[0]))
    return p


@pytest.mark.parametrize("approx", [1, 2])
def test_strain_3d_grid_matches_jax(approx):
    tj = oc.poi_grid_3d((4, 4, 4), 7, 6, 5, 3)
    x, y, z = (np.asarray(a) for a in (tj.x, tj.y, tj.z))
    rng = np.random.default_rng(approx)
    p = _linear_field(x, y, z, rng)
    r = np.zeros((tj.n, 7), np.float32)
    r[:, tpoi.R3_ZNCC] = np.where(rng.uniform(size=tj.n) < 0.1, -3.0, 0.99)
    tj = tj.replace(p=jnp.asarray(p), r=jnp.asarray(r))
    sj = oc.Strain(8.0, 10)
    sj.set_approximation(approx)
    ej = np.asarray(sj.compute(tj).e)
    st = ot.Strain(8.0, 10, device=CPU)
    st.set_approximation(approx)
    et = st.compute(_to_port_3d(tj)).e.numpy()
    assert st._cache[-1][2][0] == "grid"
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-5)


def test_strain_3d_scattered_cloud_matches_jax():
    """The k-d-tree path, exact-k fallback included, chunked."""
    rng = np.random.default_rng(9)
    n = 300
    x, y, z = (rng.uniform(0, 60, n).astype(np.float32) for _ in range(3))
    p = _linear_field(x, y, z, rng)
    r = np.zeros((n, 7), np.float32)
    r[:, tpoi.R3_ZNCC] = np.where(rng.uniform(size=n) < 0.1, -4.0, 0.95)
    e = np.zeros((n, 6), np.float32)
    sr = np.zeros((n, 3), np.float32)
    for radius, nmin in ((15.0, 8), (6.0, 12)):
        tj = oc.new_table_3d(x, y, z).replace(p=jnp.asarray(p),
                                              r=jnp.asarray(r))
        ej = np.asarray(oc.Strain(radius, nmin).compute(tj).e)
        s = ot.Strain(radius, nmin, chunk_size=128, device=CPU)
        et = s.compute(ot.table_from_numpy_3d(x, y, z, p, r, e, sr,
                                              device=CPU)).e.numpy()
        assert s._cache[-1][2][0] == "kdtree"
        np.testing.assert_allclose(et, ej, rtol=0, atol=1e-5)
