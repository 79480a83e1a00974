"""The port's stereo geometry, I/O and stereo strain against the JAX
package on the CPU: Rodrigues rotations and fundamental matrices within
1e-6 relative, the undistortion maps and ``undistort`` within 1e-4 px,
``reconstruct`` within 1e-3 mm (a NaN point gives exactly 0), calibration
and 2DS CSVs equal after parsing, ``strain2ds`` within 1e-5."""

import numpy as np
import pytest
import torch

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu.io import calibration_io as jcio
from opencorr_tpu.io import table as jtable
from opencorr_tpu.models import calibration as jcal
from opencorr_tpu.models import stereovision as jsv
from opencorr_tpu_torch.models import calibration as tcal
from opencorr_tpu_torch.models import stereovision as tsv

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"

# tests/test_stereo.py's cameras, and the GT4 example's
# (examples/stereo_3d_dic_epipolar_sift.py:48-57)
CAMS = {
    "test": (dict(fx=2000.0, fy=2000.0, cx=320.0, cy=240.0, k1=0.01,
                  k2=-0.05),
             dict(),
             dict(fx=2100.0, fy=2100.0, cx=300.0, cy=250.0, k1=0.02),
             dict(tx=100.0, ty=2.0, tz=10.0, rx=0.01, ry=-0.3, rz=0.005)),
    "gt4": (dict(fx=6673.315918, fy=6669.302734, fs=0.0, cx=872.15778,
                 cy=579.95532, k1=0.032258954, k2=-1.01141417,
                 k3=29.78838921),
            dict(),
            dict(fx=6607.618164, fy=6602.857422, fs=0.0, cx=917.9733887,
                 cy=531.6352539, k1=0.064598486, k2=-4.531373978,
                 k3=29.78838921),
            dict(tx=122.24886, ty=1.8488892, tz=17.624638, rx=0.00307711,
                 ry=-0.33278773, rz=0.00524556)),
    # skew, tangential and rational terms
    "full": (dict(fx=1800.0, fy=1750.0, fs=2.5, cx=300.0, cy=220.0,
                  k1=-0.08, k2=0.3, k3=-0.5, k4=0.01, k5=-0.02, k6=0.005,
                  p1=1e-3, p2=-2e-3),
             dict(tx=-1.0, ty=0.5, rz=0.02),
             dict(fx=1900.0, fy=1900.0, cx=330.0, cy=230.0, p1=-5e-4),
             dict(tx=95.0, ty=-3.0, tz=12.0, rx=-0.02, ry=-0.28,
                  rz=-0.01)),
}


def _pair(lib, name, device=None):
    i1, e1, i2, e2 = CAMS[name]
    kw = {} if lib is oc else dict(device=device)
    return (lib.Calibration(lib.CameraIntrinsics(**i1),
                            lib.CameraExtrinsics(**e1), **kw),
            lib.Calibration(lib.CameraIntrinsics(**i2),
                            lib.CameraExtrinsics(**e2), **kw))


@pytest.mark.parametrize("v", [(0.0, 0.0, 0.0), (0.0, 0.0, np.pi / 2),
                               (0.3, -0.2, 0.5),
                               (0.00307711, -0.33278773, 0.00524556)])
def test_rodrigues(v):
    want = jcal.rodrigues(*v)
    got = tcal.rodrigues(*v)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(CAMS))
def test_fundamental_and_projection_matrices(name):
    j1, j2 = _pair(oc, name)
    t1, t2 = _pair(ot, name, CPU)
    for a, b in ((t1, j1), (t2, j2)):
        np.testing.assert_allclose(a.projection_matrix, b.projection_matrix,
                                   rtol=1e-6)
    want = jsv.fundamental_matrix(j1, j2)
    got = tsv.fundamental_matrix(t1, t2)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name,hw", [("test", (96, 128)), ("gt4", (120, 200)),
                                     ("full", (100, 140))])
def test_undistortion_maps_and_undistort(name, hw):
    """The whole-image fixed-point maps (40 iterations, conv 0.001) and the
    bilinear ``undistort`` of points in and past the image."""
    for cj, ct in zip(_pair(oc, name), _pair(ot, name, CPU)):
        cj.prepare(*hw)
        ct.prepare(*hw)
        i = cj.intrinsics
        dx = np.abs(ct.map_x.numpy() - np.asarray(cj.map_x)) * i.fx
        dy = np.abs(ct.map_y.numpy() - np.asarray(cj.map_y)) * i.fy
        assert ct.map_x.dtype == torch.float32
        assert dx.max() < 1e-4 and dy.max() < 1e-4
        rng = np.random.default_rng(hw[0])
        xs = rng.uniform(-3, hw[1] + 3, 500).astype(np.float32)
        ys = rng.uniform(-3, hw[0] + 3, 500).astype(np.float32)
        want = [np.asarray(a) for a in cj.undistort(xs, ys)]
        got = [a.numpy() for a in ct.undistort(xs, ys)]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def _project(cam, world, distort=True):
    """World points -> distorted sensor coordinates (float64)."""
    r = cam.rotation_matrix.astype(np.float64)
    t = cam.translation_vector.astype(np.float64)
    xc = world @ r.T + t
    x, y = xc[:, 0] / xc[:, 2], xc[:, 1] / xc[:, 2]
    i = cam.intrinsics
    if distort:
        r2 = x * x + y * y
        rad = ((1 + i.k1 * r2 + i.k2 * r2 ** 2 + i.k3 * r2 ** 3)
               / (1 + i.k4 * r2 + i.k5 * r2 ** 2 + i.k6 * r2 ** 3))
        x, y = (x * rad + 2 * i.p1 * x * y + i.p2 * (r2 + 2 * x * x),
                y * rad + i.p1 * (r2 + 2 * y * y) + 2 * i.p2 * x * y)
    return np.stack([x * i.fx + y * i.fs + i.cx, y * i.fy + i.cy], -1)


@pytest.mark.parametrize("name", ["test", "full"])
def test_reconstruct(name):
    """Triangulation of distorted projections within 1e-3 mm of the JAX
    package's; rows with a NaN coordinate give exactly the zero point."""
    rng = np.random.default_rng(7)
    world = rng.uniform([-15, -12, 380], [15, 12, 420], (200, 3))
    sides = []
    for lib, dev in ((oc, None), (ot, CPU)):
        c1, c2 = _pair(lib, name, dev)
        for c in (c1, c2):
            c.prepare(480, 640)
        sv = lib.Stereovision(c1, c2)
        sv.prepare()
        sides.append((sv, c1, c2))
    p1 = _project(sides[0][1], world).astype(np.float32)
    p2 = _project(sides[0][2], world).astype(np.float32)
    p1[3, 0] = np.nan
    p2[7, 1] = np.nan
    want = np.asarray(sides[0][0].reconstruct(p1, p2))
    got = sides[1][0].reconstruct(p1, p2)
    assert got.dtype == torch.float32 and got.shape == (200, 3)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert (got[[3, 7]] == 0).all()
    keep = np.ones(200, bool)
    keep[[3, 7]] = False
    assert np.abs(got[keep] - world[keep]).max() < 0.05


def test_calibration_csv_both_ways(tmp_path):
    """A file written by either package loads in the other with the same
    camera parameters."""
    t1, t2 = _pair(ot, "full", CPU)
    ot.save_calibration(str(tmp_path / "t.csv"), t1, t2)
    j1, j2 = jcio.load_calibration(str(tmp_path / "t.csv"))
    jcio.save_calibration(str(tmp_path / "j.csv"), *_pair(oc, "gt4"))
    g1, g2 = ot.load_calibration(str(tmp_path / "j.csv"), device=CPU)
    for a, b in ((t1, j1), (t2, j2)):
        assert vars(a.intrinsics) == vars(b.intrinsics)
        assert vars(a.extrinsics) == vars(b.extrinsics)
    for a, b in zip((g1, g2), _pair(oc, "gt4")):
        assert vars(a.intrinsics) == vars(b.intrinsics)
        assert vars(a.extrinsics) == vars(b.extrinsics)
        assert a.device == torch.device(CPU)
    np.testing.assert_array_equal(g2.projection_matrix,
                                  _pair(oc, "gt4")[1].projection_matrix)


def _table_2ds_arrays(n=60, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 20, s).astype(np.float32)
    x = np.float32(rng.integers(20, 300, n))
    y = np.float32(rng.integers(20, 200, n))
    r = f(n, 9)
    r[:, :3] = rng.uniform(-1, 1, (n, 3))
    return dict(x=x, y=y, p=f(n, 3), r=r, ref_coor=f(n, 3),
                tar_coor=f(n, 3), e=f(n, 6) * 1e-4,
                sr=np.zeros((n, 2), np.float32))


def _jax_2ds(a):
    import jax.numpy as jnp
    t = oc.new_table_2ds(a["x"], a["y"])
    return t.replace(**{k: jnp.asarray(v) for k, v in a.items()
                        if k not in ("x", "y")})


def test_table_2ds_csv_both_ways(tmp_path):
    """save_table_2ds / load_table_2ds / save_map_2ds: the port's files
    parse equal to the JAX package's, and each loads the other's."""
    a = _table_2ds_arrays()
    tt = ot.table_from_numpy_2ds(**a, device=CPU)
    jt = _jax_2ds(a)
    ot.save_table_2ds(str(tmp_path / "t.csv"), tt)
    jtable.save_table_2ds(str(tmp_path / "j.csv"), jt)
    read = lambda p: np.genfromtxt(p, delimiter=",", skip_header=1)
    np.testing.assert_array_equal(read(tmp_path / "t.csv"),
                                  read(tmp_path / "j.csv"))
    with open(tmp_path / "t.csv") as ft, open(tmp_path / "j.csv") as fj:
        assert ft.readline() == fj.readline()
    back = ot.load_table_2ds(str(tmp_path / "j.csv"), device=CPU)
    jback = jtable.load_table_2ds(str(tmp_path / "t.csv"))
    got = ot.table_to_numpy(back)
    for k in ot.POITable2DS.FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jback, k)))
        np.testing.assert_allclose(got[k], a[k], rtol=1e-6, atol=1e-6)
    for var in ("w", "zncc_r1t2", "ezx"):
        ot.save_map_2ds(str(tmp_path / "tm.csv"), tt, var, 210, 310)
        jtable.save_map_2ds(str(tmp_path / "jm.csv"), jt, var, 210, 310)
        np.testing.assert_array_equal(
            np.genfromtxt(tmp_path / "tm.csv", delimiter=","),
            np.genfromtxt(tmp_path / "jm.csv", delimiter=","))


def _stereo_field(xs, ys, seed):
    """Reconstructed points (a tilted plane seen at ~0.06 mm a pixel, with
    a rough depth so that every neighbourhood spans three dimensions) with
    a smooth 3D displacement, and three ZNCCs per POI, some failed.  On a
    smooth surface the 3D fit is near-singular (the depth is a function of
    x and y) and float32 noise moves the z-gradients by 1e-4."""
    rng = np.random.default_rng(seed)
    n = len(xs)
    rc = np.stack([xs * 0.06 - 8, ys * 0.061 - 6,
                   400 + 0.02 * xs - 0.01 * ys + rng.normal(0, 0.6, n)], -1)
    disp = np.stack([0.5 + 0.004 * rc[:, 0] - 0.002 * rc[:, 1],
                     -0.3 + 0.003 * rc[:, 1] + 1e-3 * rc[:, 2],
                     2.0 - 0.001 * rc[:, 0] + 0.002 * rc[:, 1]], -1)
    disp += rng.normal(0, 1e-3, disp.shape)
    r = np.zeros((n, 9), np.float32)
    r[:, :3] = rng.uniform(0.92, 1.0, (n, 3))
    bad = rng.choice(n, n // 10, replace=False)
    r[bad, rng.integers(0, 3, len(bad))] = rng.choice([-3.0, 0.5], len(bad))
    return dict(x=xs.astype(np.float32), y=ys.astype(np.float32),
                p=disp.astype(np.float32), r=r, ref_coor=rc.astype(np.float32),
                tar_coor=(rc + disp).astype(np.float32),
                e=np.zeros((n, 6), np.float32),
                sr=np.zeros((n, 2), np.float32))


@pytest.mark.parametrize("layout,approx", [("grid", 1), ("grid", 2),
                                           ("scatter", 1)])
def test_strain_2ds_matches_jax(layout, approx):
    """Strain on a stereo table: the neighbours on the view-1 image grid
    (or the k-d tree for scattered points), the fit on the 3D reference
    coordinates, the gate on the smallest of the three ZNCCs."""
    if layout == "grid":
        gx, gy = np.meshgrid(np.arange(30, 250, 6), np.arange(20, 170, 6))
        xs, ys = gx.ravel().astype(np.float64), gy.ravel().astype(np.float64)
    else:
        rng = np.random.default_rng(5)
        xs = rng.uniform(20, 250, 700)
        ys = rng.uniform(20, 170, 700)
    a = _stereo_field(xs, ys, seed=len(xs))
    sj = oc.Strain(subregion_radius=20.0, neighbor_number_min=5)
    sj.set_approximation(approx)
    want = np.asarray(sj.compute(_jax_2ds(a)).e)
    st = ot.Strain(subregion_radius=20.0, neighbor_number_min=5, device=CPU)
    st.set_approximation(approx)
    tt = st.compute(ot.table_from_numpy_2ds(**a, device=CPU))
    assert isinstance(tt, ot.POITable2DS)
    got = tt.e.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    done = np.abs(want).sum(1) > 0
    assert 0.5 < done.mean() < 1.0
    assert (got[~done] == 0).all()
