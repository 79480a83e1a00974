"""The ported stereo example (``opencorr_tpu_torch.examples.
stereo_3d_dic_epipolar_sift.run``) against the JAX package's
(``examples/stereo_3d_dic_epipolar_sift.py::run``) on the CPU, and the
ported stereo strain example.

The scene is ``chip_smoke.py``'s speckled plate, rendered through the GT4
example's cameras into small images (the sensors' top-left corners), with
the same motion; the JAX example reads it as the GT4 directory layout.
Both runs get the same matched keypoints (the scene's true matches, in
place of the SIFT stage, which test_torch_stereo_sift2d.py holds) and the
same RANSAC draws.  r2, t1 and t2 within 1e-4 px, codes equal, 3D
coordinates within 1e-3 mm.  EpipolarSearch alone on the first pair: the
winning candidates, codes and iteration counts equal, u/v within 1e-4
px."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu_torch.examples import stereo_3d_dic_epipolar_sift as tex
from opencorr_tpu_torch.examples import stereo_strain as tstrain

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (224, 288)  # [H, W]
GRID = ((76, 104), 13, 8, 12)  # upper left (x, y), nx, ny, step


def gt4_calibrations(lib, **kw):
    """The example's two cameras as ``lib``'s Calibration objects."""
    return tuple(lib.Calibration(lib.CameraIntrinsics(**i),
                                 lib.CameraExtrinsics(**e), **kw)
                 for i, e in cs.STEREO_CAMS)


def small_scene(seed=5):
    """chip_smoke.py's scene at ``SIZE`` on ``GRID``: (views, POIs, truth,
    scene)."""
    return cs.stereo_inputs(SIZE, GRID, seed)


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    import cv2
    import jax

    views, pts, truth, scene = small_scene()
    data = tmp_path_factory.mktemp("gt4")
    for name, img in zip(("GT4-0000_0", "GT4-0000_1", "GT4-0273_0",
                          "GT4-0273_1"), views):
        assert cv2.imwrite(str(data / f"{name}.tif"), img)
    np.savetxt(data / "GT4-POIs.csv", pts, delimiter=",", header="x,y",
               comments="")
    # matched keypoints: the scene's true motion of points on the plate
    rng = np.random.default_rng(1)
    kp = rng.uniform((50, 50), (SIZE[1] - 40, SIZE[0] - 40), (600, 2))
    matches = (kp.astype(np.float32),
               scene.truth(kp)["t1"].astype(np.float32))
    spec = importlib.util.spec_from_file_location(
        "jax_stereo_example",
        os.path.join(ROOT, "examples", "stereo_3d_dic_epipolar_sift.py"))
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    want, _ = jex.run(str(data), out_path=str(data / "jax.csv"),
                      sift_matches=matches)
    draws = np.array(jax.random.randint(jax.random.PRNGKey(0),
                                          (3, len(pts), 20), 0, 1 << 30))
    c1, c2 = gt4_calibrations(ot, device="cpu")
    stats = {}
    got, times = tex.run(*[ot.Image2D.from_array(v) for v in views], pts, c1,
                         c2, out_path=str(data / "port.csv"),
                         sift_matches=matches,
                         ransac_draws=torch.from_numpy(draws), stats=stats,
                         device="cpu")
    return dict(want=want, got=got, times=times, truth=truth, data=data,
                pts=pts, stats=stats, views=views)


def test_stereo_run_matches_jax_example(both_runs):
    j = {f: np.asarray(getattr(both_runs["want"], f))
         for f in ot.POITable2DS.FIELDS}
    t = ot.table_to_numpy(both_runs["got"])
    for c in range(3):  # r1r2, r1t1, r1t2: codes equal
        np.testing.assert_array_equal(np.where(t["r"][:, c] < 0, t["r"][:, c],
                                               1),
                                      np.where(j["r"][:, c] < 0, j["r"][:, c],
                                               1))
    np.testing.assert_allclose(t["r"][:, :3], j["r"][:, :3], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t["r"][:, 3:], j["r"][:, 3:], rtol=0,
                               atol=1e-4)
    for f in ("ref_coor", "tar_coor", "p"):
        np.testing.assert_allclose(t[f], j[f], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(t["x"], j["x"])
    assert set(both_runs["times"]) == {
        "r1_to_r2", "epipolar_r2", "icgn2d2_r2", "r1_to_t1", "sift2d",
        "feature_affine2d", "icgn2d1", "r1_to_t2", "epipolar_t2",
        "icgn2d2_t2", "reconstruction", "save_table_2ds"}
    stats = both_runs["stats"]
    assert stats["matches"] == 600
    assert stats["feature_affine2d_codes"] == {
        "0.0": len(t["x"]), "-1.0": 0, "-2.0": 0}
    assert stats["epipolar_icgn"]["iter_full"] > 0
    read = lambda p: np.genfromtxt(p, delimiter=",", skip_header=1)
    np.testing.assert_allclose(read(both_runs["data"] / "port.csv"),
                               read(both_runs["data"] / "jax.csv"), rtol=0,
                               atol=1e-3)


def test_stereo_run_recovers_the_scene(both_runs):
    """Against the rendered truth: every pair converged, positions within
    0.02 px on average, the 3D displacement close to the imposed one."""
    t = ot.table_to_numpy(both_runs["got"])
    truth = both_runs["truth"]
    ok = (t["r"][:, :3] > 0.9).all(1)
    assert ok.mean() > 0.9
    for k, cols in (("r2", [3, 4]), ("t1", [5, 6]), ("t2", [7, 8])):
        err = np.abs(t["r"][ok][:, cols] - truth[k][ok]).mean()
        assert err < cs.STEREO_TOL_PX, (k, err)
    d3 = np.linalg.norm(t["p"][ok] - truth["disp"][ok], axis=1).mean()
    assert d3 < 0.02


def test_stereo_strain_example(both_runs, tmp_path):
    """examples/stereo_strain.py's Strain(20, 5): from a stereo CSV against
    the JAX package's strain of the same file, on reconstructed points that
    span three dimensions (test_torch_stereo_calib.py's field), and on the
    run's own table.  On the plate every neighbourhood lies in one plane,
    where the 3D gradient fit is singular and float32 rounding decides the
    values (ROADMAP §3): there the example only has to fill the table."""
    from opencorr_tpu.io import table as jtable
    from test_torch_stereo_calib import _stereo_field

    gx, gy = np.meshgrid(np.arange(30, 250, 6), np.arange(20, 170, 6))
    a = _stereo_field(gx.ravel().astype(np.float64),
                      gy.ravel().astype(np.float64), seed=9)
    src = str(tmp_path / "field.csv")
    ot.save_table_2ds(src, ot.table_from_numpy_2ds(**a, device="cpu"))
    want = oc.Strain(subregion_radius=20.0, neighbor_number_min=5).compute(
        jtable.load_table_2ds(src))
    out = tmp_path / "strain.csv"
    got, seconds = tstrain.run(src, out_path=str(out), device="cpu")
    np.testing.assert_allclose(got.e.numpy(), np.asarray(want.e), rtol=0,
                               atol=1e-5)
    assert seconds > 0 and out.exists()
    plate, _ = tstrain.run(both_runs["got"], device="cpu")
    assert plate.e.shape == (len(both_runs["pts"]), 6)
    assert (plate.e.numpy() != 0).any(1).mean() > 0.8


def test_epipolar_search_matches_jax(both_runs):
    """The coarse search of the stereo example's first phase (radius 30,
    step 5, r=20, conv 0.05, 10 iterations, parallax (-30, -40)) on the
    scene's first pair: winners, codes and iteration counts equal, u/v
    within 1e-4 px (in the same process as the JAX example's run, whose
    compile it reuses)."""
    views, pts, truth = both_runs["views"], both_runs["pts"], both_runs["truth"]
    cams = {oc: gt4_calibrations(oc), ot: gt4_calibrations(ot, device="cpu")}
    outs = {}
    for lib, kw in ((oc, {}), (ot, dict(device="cpu"))):
        epi = lib.EpipolarSearch(*cams[lib], **kw)
        epi.set_parallax((-30.0, -40.0))
        epi.set_search(30, 5)
        epi.create_icgn(20, 20, 0.05, 10)
        epi.set_images(views[0], views[1])
        epi.prepare()
        t = lib.new_table_2d(pts[:, 0], pts[:, 1], **kw)
        out = epi.compute(t)
        outs[lib] = {f: np.asarray(getattr(out, f)) if lib is oc
                     else getattr(out, f).numpy() for f in ("p", "r")}
    j, t = outs[oc], outs[ot]
    zj, zt = j["r"][:, 2], t["r"][:, 2]
    np.testing.assert_array_equal(np.where(zt < 0, zt, 1),
                                  np.where(zj < 0, zj, 1))
    np.testing.assert_array_equal(t["r"][:, 3], j["r"][:, 3])
    np.testing.assert_allclose(t["p"], j["p"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t["r"][:, 2], j["r"][:, 2], rtol=0, atol=1e-5)
    ok = t["r"][:, 2] > 0.9
    assert ok.mean() > 0.9
    # the coarse search lands within its convergence criterion of the truth
    r2 = pts + t["p"][:, [0, 6]]
    assert np.median(np.abs(r2[ok] - truth["r2"][ok])) < 0.05
