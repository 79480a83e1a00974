"""The ported DVC and surface-reconstruction examples against the JAX
package's on the CPU, and ``speckle_quality.assess``.

* ``examples/dvc.run``: ``fftcc_icgn1`` on the example's own synthetic pair
  (96^3, r=10, 216 POIs), ``sift_icgn1`` on ``.bin`` files of
  tests/test_torch_sift3d_pipeline.py's 52^3 pair with a POI CSV (r=16),
  and ``strain`` from one result table: codes equal, u/v/w within 2e-5
  voxel, strain within 1e-5, the same stage names in ``*_time.csv``, the
  ``.bin`` matrices' headers equal and their records within the same
  gates.  ``sift_icgn1`` runs both examples end to end, SIFT3D's host
  path (the default of both packages) included, whose matches must be
  equal; FeatureAffine3D gets the JAX package's draws.
* ``fit_parallax`` equal to the JAX example's.
* EpipolarSearch with a non-zero bilinear ``set_parallax``: codes and
  iteration counts equal, u/v within 1e-5 px.
* ``examples/reconstruction_epipolar.run`` in both modes against the JAX
  example on a top-left crop of chip_smoke.py's reconstruction scene (a
  crop keeps every pixel's coordinates, so the GT4 cameras stay valid):
  view-2 positions within 1e-4 px, codes equal, 3D points within 1e-3 mm;
  SIFT2D's matches are the scene's exact ones in both runs.
* ``speckle_quality.assess`` against the JAX one (skipped without cv2).
"""

import contextlib
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu_torch.examples import dvc as tdvc
from opencorr_tpu_torch.examples import reconstruction_epipolar as trec
from opencorr_tpu_torch.utils import speckle_quality as tsq

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
RECON_SIZE = (260, 320)  # [H, W]: 288 POIs on the example's grid


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_csv(path):
    with open(path) as f:
        header = f.readline().strip()
    return header, np.genfromtxt(path, delimiter=",", skip_header=1)


def _assert_3d_tables(t, j, tol=2e-5):
    zt, zj = t["r"][:, 3], j["r"][:, 3]
    np.testing.assert_array_equal(np.where(zt < 0, zt, 1),
                                  np.where(zj < 0, zj, 1))
    np.testing.assert_array_equal(t["x"], j["x"])
    np.testing.assert_array_equal(t["z"], j["z"])
    np.testing.assert_allclose(t["p"][:, [0, 4, 8]], j["p"][:, [0, 4, 8]],
                               rtol=0, atol=tol)
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-5)


def _assert_outputs(prefix_t, prefix_j, workload):
    """The two examples' files of ``workload``: the result CSVs within the
    gates, the time CSVs' stage names equal, the .bin matrices' headers
    equal and their records within the gates."""
    ht, ct = _read_csv(f"{prefix_t}_{workload}.csv")
    hj, cj = _read_csv(f"{prefix_j}_{workload}.csv")
    assert ht == hj
    np.testing.assert_allclose(ct, cj, rtol=0, atol=2e-5)
    assert (_read_csv(f"{prefix_t}_{workload}_time.csv")[0]
            == _read_csv(f"{prefix_j}_{workload}_time.csv")[0])
    rt, dt = ot.load_matrix_bin_3d(f"{prefix_t}_{workload}.bin")
    from opencorr_tpu.io import table as jtable

    rj, dj = jtable.load_matrix_bin_3d(f"{prefix_j}_{workload}.bin")
    assert dt == dj and rt.shape == rj.shape
    np.testing.assert_array_equal(rt[:, :3], rj[:, :3])
    np.testing.assert_allclose(rt[:, 3:], rj[:, 3:], rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def jdvc():
    return _jax_example("dvc")


@pytest.fixture(scope="module")
def fftcc_runs(jdvc, tmp_path_factory):
    out = tmp_path_factory.mktemp("dvc")
    want, jt = jdvc.run("fftcc_icgn1", out_prefix=str(out / "jax"))
    stats = {}
    got, tt = tdvc.run("fftcc_icgn1", out_prefix=str(out / "port"),
                       device=CPU, stats=stats)
    return dict(out=out, want=want, got=got, jt=jt, tt=tt, stats=stats)


def test_dvc_fftcc_icgn1_matches_jax(fftcc_runs):
    r = fftcc_runs
    j = {f: np.asarray(getattr(r["want"], f)) for f in ot.POITable3D.FIELDS}
    t = ot.table_to_numpy(r["got"])
    _assert_3d_tables(t, j)
    assert (t["r"][:, 3] > 0.9).mean() > 0.9
    # the synthetic pair's translation (0.5, -0.8, 1.2)
    ok = t["r"][:, 3] > 0.9
    np.testing.assert_allclose(np.median(t["p"][ok][:, [0, 4, 8]], 0),
                               (0.5, -0.8, 1.2), atol=0.01)
    assert r["tt"].names == r["jt"].names == ["FFTCC", "ICGN"]
    _assert_outputs(r["out"] / "port", r["out"] / "jax", "fftcc_icgn1")
    assert r["stats"]["icgn_stats"]["lattice"] > 0


def test_dvc_strain_matches_jax(fftcc_runs, jdvc):
    """Both examples' strain workload on the JAX example's table."""
    out = fftcc_runs["out"]
    table = str(out / "jax_fftcc_icgn1.csv")
    want, jt = jdvc.run("strain", table, out_prefix=str(out / "jax"))
    got, tt = tdvc.run("strain", table, out_prefix=str(out / "port"),
                       device=CPU)
    np.testing.assert_allclose(got.e.numpy(), np.asarray(want.e), rtol=0,
                               atol=1e-5)
    assert tt.names == jt.names == ["Strain calculation"]
    ht, ct = _read_csv(str(out / "port_strain_r30.csv"))
    hj, cj = _read_csv(str(out / "jax_strain_r30.csv"))
    assert ht == hj
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-5)
    assert (_read_csv(str(out / "port_strain_r30_time.csv"))[0]
            == _read_csv(str(out / "jax_strain_r30_time.csv"))[0])


def _sift_pair(path):
    """tests/test_torch_sift3d_pipeline.py's 52^3 pair as OpenCorr .bin
    files, and 8 POIs as a CSV."""
    from scipy.ndimage import gaussian_filter, shift as ndshift

    d = 52
    rng = np.random.default_rng(2)
    base = gaussian_filter(rng.standard_normal((d + 20,) * 3).astype(
        np.float32), 1.5) * 50 + 128
    ref = base[10:10 + d, 10:10 + d, 10:10 + d]
    tar = ndshift(base, (2.0, -1.0, 1.5), order=3)[10:10 + d, 10:10 + d,
                                                   10:10 + d]
    names = []
    for name, vol in (("ref", ref), ("tar", tar)):
        names.append(str(path / f"{name}.bin"))
        ot.Image3D.from_array(vol).save_bin(names[-1])
    g = np.stack(np.meshgrid([20.0, 30.0], [20.0, 30.0], [20.0, 30.0],
                             indexing="ij"), -1).reshape(-1, 3)
    names.append(str(path / "pois.csv"))
    np.savetxt(names[-1], g[:, ::-1], delimiter=",", header="x,y,z",
               comments="")
    return names


class _Matches:
    """A SIFT stage that yields given matches."""

    def __init__(self, ref_kp, tar_kp):
        self.ref_matched_kp, self.tar_matched_kp = ref_kp, tar_kp

    def set_images(self, *_):
        pass

    def prepare(self):
        pass

    def compute(self):
        pass


@contextlib.contextmanager
def _jax_sift_matches():
    """Yields [ref_kp, tar_kp], filled with the matches of the JAX
    package's SIFT3D modules computed inside the block."""
    got = []
    compute = oc.SIFT3D.compute

    def spy(self):
        compute(self)
        got[:] = [self.ref_matched_kp, self.tar_matched_kp]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(oc.SIFT3D, "compute", spy)
        yield got


def test_dvc_sift_icgn1_matches_jax(jdvc, tmp_path):
    import jax

    ref, tar, csv = _sift_pair(tmp_path)
    stats = {}
    draws = np.array(jax.random.randint(jax.random.PRNGKey(0), (4, 8, 32), 0,
                                        1 << 30))
    got, tt = tdvc.run("sift_icgn1", ref, tar, csv, str(tmp_path / "port"),
                       device=CPU, ransac_draws=torch.from_numpy(draws),
                       stats=stats)
    kp = stats["sift_matches"]
    with _jax_sift_matches() as jkp:
        want, jt = jdvc.run("sift_icgn1", ref, tar, csv,
                            str(tmp_path / "jax"))
    for a, b in zip(kp, jkp):
        np.testing.assert_array_equal(a, b)
    assert len(kp[0]) >= 8
    assert {st["route"] for st in stats["sift3d_layers"]
            if "route" in st} >= {"kernel 4"}
    j = {f: np.asarray(getattr(want, f)) for f in ot.POITable3D.FIELDS}
    t = ot.table_to_numpy(got)
    _assert_3d_tables(t, j)
    assert stats["feature_affine3d_codes"] == {"0.0": 8, "-1.0": 0,
                                               "-2.0": 0}
    assert (t["r"][:, 3] > 0.9).all()
    np.testing.assert_allclose(t["p"][:, [8, 4, 0]],
                               np.broadcast_to((2.0, -1.0, 1.5), (8, 3)),
                               atol=0.02)
    assert tt.names == jt.names == ["SIFT", "FeatureAffine", "ICGN"]
    _assert_outputs(tmp_path / "port", tmp_path / "jax", "sift_icgn1")


def test_dvc_example_rejects_unknown_workload():
    with pytest.raises(ValueError, match="unknown workload"):
        tdvc.run("icgn", device=CPU)


def test_fit_parallax_matches_jax():
    jrec = _jax_example("reconstruction_epipolar")
    rng = np.random.default_rng(4)
    ref_kp = rng.uniform(0, 400, (300, 2)).astype(np.float32)
    tar_kp = (ref_kp + rng.normal((-30, -40), 2.0, (300, 2))).astype(
        np.float32)
    for w, h in ((400, 300), (1920, 1200), (401, 299)):
        for a, b in zip(trec.fit_parallax(ref_kp, tar_kp, w, h),
                        jrec.fit_parallax(ref_kp, tar_kp, w, h)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def recon_scene():
    views, pts, r2, scene = cs.recon_inputs(RECON_SIZE, seed=7)
    matches = cs.recon_sift_matches(scene, 1500, seed=3)
    return dict(views=views, pts=pts, r2=r2, scene=scene, matches=matches)


def _gt4(lib, **kw):
    return tuple(lib.Calibration(lib.CameraIntrinsics(**i),
                                 lib.CameraExtrinsics(**e), **kw)
                 for i, e in cs.STEREO_CAMS)


def _assert_search_equal(t, j, conv, tol):
    """Two searches' (p, r): codes equal; where the winning candidate (its
    start u0, v0) is the same, iteration counts equal and u/v within
    ``tol``.  Where two candidates converge to one optimum, their ZNCCs tie
    within float noise and the first maximum may pick either: at most 1% of
    POIs, ZNCC within 1e-6 and u/v within ``conv``."""
    zj, zt = j["r"][:, 2], t["r"][:, 2]
    np.testing.assert_array_equal(np.where(zt < 0, zt, 1),
                                  np.where(zj < 0, zj, 1))
    tie = (t["r"][:, :2] != j["r"][:, :2]).any(1)
    assert tie.sum() <= max(1, len(zt) // 100)
    np.testing.assert_allclose(zt[tie], zj[tie], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t["p"][tie][:, [0, 6]],
                               j["p"][tie][:, [0, 6]], rtol=0, atol=conv)
    same = ~tie
    np.testing.assert_array_equal(t["r"][same, 3], j["r"][same, 3])
    np.testing.assert_allclose(t["p"][same][:, [0, 6]],
                               j["p"][same][:, [0, 6]], rtol=0, atol=tol)
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-5)
    return tie


def test_bilinear_parallax_search_matches_jax(recon_scene):
    """EpipolarSearch with the parallax fitted to the scene's matches (a, b
    non-zero in x and y), at radius 8, step 2 on every fourth POI: the
    candidates' starts (u0, v0 of the winners) equal, u/v within 1e-5 px
    (:func:`_assert_search_equal`)."""
    views = recon_scene["views"]
    pts = recon_scene["pts"][::4]
    cx, cy = trec.fit_parallax(*recon_scene["matches"], RECON_SIZE[1],
                               RECON_SIZE[0])
    assert (np.abs(cx[:2]) > 1e-3).all() and (np.abs(cy[:2]) > 1e-3).all()
    h, w = RECON_SIZE
    outs = {}
    for lib, kw in ((oc, {}), (ot, dict(device=CPU))):
        cams = _gt4(lib, **kw)
        for c in cams:
            c.prepare(h, w)
        epi = lib.EpipolarSearch(*cams, **kw)
        epi.set_parallax(cx, cy)
        epi.set_search(8, 2)
        epi.create_icgn(20, 20, 0.05, 5)
        epi.set_images(views[0], views[1])
        epi.prepare()
        out = epi.compute(lib.new_table_2d(pts[:, 0], pts[:, 1], **kw))
        outs[lib] = {f: np.asarray(getattr(out, f)) if lib is oc
                     else getattr(out, f).numpy() for f in ("p", "r")}
    _assert_search_equal(outs[ot], outs[oc], 0.05, 1e-5)
    assert (outs[ot]["r"][:, 2] > 0.9).mean() > 0.9


@contextlib.contextmanager
def _recording(module, key, calls):
    """``module.<key>``'s reconstruct() records its view-2 points (the JAX
    example returns only the rows)."""
    cls = getattr(module, key)

    class Recording(cls):
        def reconstruct(self, p1, p2):
            calls.append(np.asarray(p2))
            return super().reconstruct(p1, p2)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, key, Recording)
        yield


@pytest.mark.parametrize("use_sift", [True, False])
def test_reconstruction_matches_jax(recon_scene, tmp_path, use_sift):
    """Both packages' examples on the crop: x, y equal, codes equal, zncc
    within 1e-5, view-2 positions within 1e-4 px, 3D points within 1e-3
    mm; and the positions at the scene's truth (mean within 0.02 px)."""
    import cv2

    jrec = _jax_example("reconstruction_epipolar")
    views, pts = recon_scene["views"], recon_scene["pts"]
    paths = [str(tmp_path / f"view{k}.tif") for k in (1, 2)]
    for p, v in zip(paths, views):
        assert cv2.imwrite(p, v)
    matches = recon_scene["matches"]
    jcalls = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(pytest.MonkeyPatch.context()).setattr(
            oc, "SIFT2D", lambda *a, **k: _Matches(*matches))
        stack.enter_context(_recording(oc, "Stereovision", jcalls))
        want, jt = jrec.run(use_sift, *paths, str(tmp_path / "jax.csv"))
    stats = {}
    got, tt = trec.run(use_sift, *paths, str(tmp_path / "port.csv"),
                       device=CPU, sift_matches=matches, stats=stats)
    view2 = stats["view2_points"].numpy()
    assert got.shape == want.shape == (len(pts), 6)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_array_equal(got[:, :2], pts)
    zt, zj = got[:, 5], want[:, 5]
    np.testing.assert_array_equal(np.where(zt < 0, zt, 1),
                                  np.where(zj < 0, zj, 1))
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(view2, jcalls[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:, 2:5], want[:, 2:5], rtol=0, atol=1e-3)
    read = lambda p: np.genfromtxt(p, delimiter=",", skip_header=1)
    np.testing.assert_allclose(read(tmp_path / "port.csv"),
                               read(tmp_path / "jax.csv"), rtol=0, atol=1e-3)
    assert tt.names == jt.names == (
        ["SIFT", "Parallax fit", "Epipolar matching", "Reconstruction"]
        if use_sift else ["Epipolar matching", "Reconstruction"])
    ok = zt > 0.9
    assert ok.mean() > 0.9
    err = np.abs(view2[ok] - recon_scene["r2"][ok]).mean()
    assert err < cs.STEREO_TOL_PX, err
    if use_sift:
        assert stats["matches"] == len(matches[0])


def test_speckle_quality_matches_jax():
    """The metrics of one speckle pair: the port's SIFT2D runs, and its
    matches replace the JAX assess's SIFT2D stage (about 50 s of compiling
    here; tests/test_torch_stereo_sift2d.py holds the two SIFT2D against
    each other): cv2's keypoint counts, the match count, density, evenness
    and DEF equal."""
    pytest.importorskip("cv2")
    import opencorr_tpu.models.sift2d as jsift2d
    from opencorr_tpu.utils import speckle_quality as jsq
    from opencorr_tpu_torch.models import sift2d as tsift2d
    from scipy.ndimage import gaussian_filter, shift as ndshift

    rng = np.random.default_rng(4)
    base = gaussian_filter(rng.standard_normal((168, 168)), 2.0)
    base = base / base.std() * 28 + 128
    ref = np.clip(np.round(base[20:-20, 20:-20]), 0, 255).astype(np.float32)
    tar = np.clip(np.round(ndshift(base, (1.3, -0.6), order=3)[20:-20,
                                                              20:-20]),
                  0, 255).astype(np.float32)
    runs = []

    class Recording(tsift2d.SIFT2D):
        def compute(self):
            super().compute()
            runs.append((self.ref_matched_kp, self.tar_matched_kp))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsift2d, "SIFT2D", Recording)
        got = tsq.assess(ref, tar, device=CPU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsift2d, "SIFT2D", lambda *a, **k: _Matches(*runs[0]))
        want = jsq.assess(ref, tar)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.matches > 100 and 0 < got.mean_error < 0.2
    few = tsq.assess(ref, np.full_like(ref, 128.0), device=CPU)
    assert few.matches < 3 and few.evenness == float("inf")
