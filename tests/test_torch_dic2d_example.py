"""The ported planar example suite (``opencorr_tpu_torch.examples.dic_2d``)
against the JAX package's modules composed the same way, on the CPU; the
port's StageTimer and native table codec.

Each of the seven workloads runs end to end through the torch example on
small 8-bit pairs written as BMP files, on a small grid: FFTCC-seeded
ICGN2D1, ICLM2D1 and NR2D1 on a translated and strained pair; SIFT-seeded
ICGN2D2 and ICLM2D2 on a pair rotated 170 degrees; the self-adaptive chain
on a stretched pair; and ``strain`` from the table the example wrote.  The
feature workloads get the pair's true matches in place of SIFT2D (which
test_torch_stereo_sift2d.py holds) and the JAX package's RANSAC draws; one
more run keeps the port's own SIFT2D.  Tolerances are those of the
modules' own tests: first order u/v within 1e-5 px, second order median
1e-5 and worst 5e-5, NR as test_torch_iclm_nr.py, strain within 1e-5,
FeatureAffine2D's moved POIs and radii equal."""

import os

import jax
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, map_coordinates

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu.io import table as jtable
from opencorr_tpu.utils.timing import StageTimer as JaxStageTimer
from opencorr_tpu_torch.data import poi as tpoi
from opencorr_tpu_torch.examples import dic_2d
from opencorr_tpu_torch.io import native, table as ttable
from test_torch_iclm_nr import _assert_nr_equal
from test_torch_icgn_queue import _assert_icgn_equal
from test_torch_stereo_icgn import _assert_close_12

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"
# per workload: the pair, the grid, and the JAX example's stage names
PAIRS = {"shift": (170, 150), "rotate": (160, 160), "stretch": (200, 200)}
CASES = {
    "fftcc_icgn1": ("shift", ((40, 40), 5, 6, 16), ["FFTCC", "ICGN1"]),
    "fftcc_iclm1": ("shift", ((40, 40), 5, 6, 16), ["FFTCC", "ICLM1"]),
    "fftcc_nr1": ("shift", ((40, 40), 5, 6, 16), ["FFTCC", "NR1"]),
    "sift_icgn2": ("rotate", ((56, 56), 5, 5, 12),
                   ["SIFT", "FeatureAffine", "ICGN2"]),
    "sift_iclm2": ("rotate", ((56, 56), 5, 5, 12),
                   ["SIFT", "FeatureAffine", "ICLM2"]),
    "self_adaptive": ("stretch", ((50, 50), 6, 6, 20),
                      ["Feature extraction and matching",
                       "Subset optimization", "ICGN", "Strain"]),
}


def _warp_pair(shape, a, t, seed):
    """8-bit (ref, tar, map): tar(A (X - c) + c + t) = ref(X), the map
    taking reference points to target points."""
    h, w = shape
    pad = 24
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.standard_normal((h + 2 * pad, w + 2 * pad)),
                           1.5)
    base = base / base.std() * 28.0 + 128.0
    ref = np.clip(np.round(base[pad:pad + h, pad:pad + w]), 0, 255)
    c = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    a = np.asarray(a, np.float64)
    ainv = np.linalg.inv(a)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    q = np.stack([xx - c[0] - t[0], yy - c[1] - t[1]], -1) @ ainv.T + c
    tar = map_coordinates(base, [q[..., 1] + pad, q[..., 0] + pad], order=3,
                          mode="nearest")
    tar = np.clip(np.round(tar), 0, 255)

    def fwd(pts):
        return (pts - c) @ a.T + c + np.asarray(t)

    return ref.astype(np.uint8), tar.astype(np.uint8), fwd


def _true_matches(shape, fwd, n, seed):
    h, w = shape
    rng = np.random.default_rng(seed)
    ref = rng.uniform(8, min(h, w) - 8, (n, 2))
    tar = fwd(ref)
    keep = ((tar > 8) & (tar < np.array([w, h]) - 8)).all(1)
    return ref[keep].astype(np.float32), tar[keep].astype(np.float32)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("dic2d")
    th = np.deg2rad(170.0)
    rot = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    specs = {"shift": ([[1.005, 0.0], [0.0, 1.005]], (1.37, -0.62), 0),
             "rotate": (rot, (0.3, -0.4), 1),
             "stretch": ([[1.005, 0.0], [0.0, 1.0]], (0.6, -0.35), 2)}
    out = {}
    for name, (a, t, seed) in specs.items():
        ref, tar, fwd = _warp_pair(PAIRS[name], a, t, seed)
        paths = [str(d / f"{name}_{i}.bmp") for i in (0, 1)]
        for p, img in zip(paths, (ref, tar)):
            assert cv2.imwrite(p, img)
        n_kp = {"shift": 0, "rotate": 1500, "stretch": 600}[name]
        out[name] = dict(paths=paths, ref=ref.astype(np.float32),
                         tar=tar.astype(np.float32),
                         kp=_true_matches(PAIRS[name], fwd, n_kp, seed))
    return d, out


def _jax_chain(workload, pair, grid):
    """The JAX example's chain for ``workload``, composed from the JAX
    modules with ``pair``'s true matches; returns the table."""
    ref, tar = pair["ref"], pair["tar"]
    pois = oc.poi_grid_2d(*grid)
    r = dic_2d.RADIUS[workload]
    if workload.startswith("fftcc"):
        f = oc.FFTCC2D(r, r)
        f.set_images(ref, tar)
        pois = f.compute(pois)
        cls = {"fftcc_icgn1": oc.ICGN2D1, "fftcc_iclm1": oc.ICLM2D1,
               "fftcc_nr1": oc.NR2D1}[workload]
        m = cls(r, r, 0.001, 10)
    else:
        fa = oc.FeatureAffine2D(r, r)
        if workload == "self_adaptive":
            fa.set_search(float(np.sqrt(2.0 * r * r)), 14)
            fa.set_self_adaptive(True)
            fa.set_subset_adjustment(14, 10)
        fa.set_keypoint_pair(*pair["kp"])
        pois = fa.compute(pois)
        cls = {"sift_icgn2": oc.ICGN2D2, "sift_iclm2": oc.ICLM2D2,
               "self_adaptive": oc.ICGN2D1}[workload]
        m = cls(r, r, 0.001, 10)
        m.set_self_adaptive(workload == "self_adaptive")
    m.set_images(ref, tar)
    m.prepare()
    pois = m.compute(pois)
    if workload == "self_adaptive":
        pois = oc.Strain(25.0, 10).compute(pois)
    return pois


def _numpy(t):
    return {f: np.asarray(getattr(t, f)) for f in ("x", "y", "p", "r", "e",
                                                   "sr")}


@pytest.mark.parametrize("workload", list(CASES))
def test_workload_matches_jax(pairs, workload):
    d, data = pairs
    pair_name, grid, stages = CASES[workload]
    pair = data[pair_name]
    n = grid[1] * grid[2]
    draws = None
    if not workload.startswith("fftcc"):
        draws = torch.from_numpy(np.array(jax.random.randint(
            jax.random.PRNGKey(0), (3, n, 20), 0, 1 << 30)))
    prefix = str(d / "torch")
    info = {}
    out, timer = dic_2d.run(workload, *pair["paths"], prefix, CPU, grid=grid,
                            sift_matches=None if draws is None else
                            pair["kp"], ransac_draws=draws, stats=info)
    got = ot.table_to_numpy(out)
    j = _numpy(_jax_chain(workload, pair, grid))
    if workload == "fftcc_nr1":
        _assert_nr_equal(j, got)
    elif workload in ("sift_icgn2", "sift_iclm2"):
        _assert_close_12(j, got)
    else:
        _assert_icgn_equal(j, got)
    for f in ("x", "y", "sr"):
        np.testing.assert_array_equal(got[f], j[f])
    np.testing.assert_allclose(got["e"], j["e"], rtol=0, atol=1e-5)
    assert (got["r"][:, tpoi.R_ZNCC] > 0.9).mean() > 0.9
    assert timer.names == stages
    for suffix, rows in (("", n), ("_deformation", n)):
        with open(f"{prefix}_{workload}{suffix}.csv") as fh:
            assert sum(1 for _ in fh) == rows + 1
    with open(f"{prefix}_{workload}_time.csv") as fh:
        assert fh.readline().rstrip("\n").split(",") == ["POI number"] + stages
    assert info["writer"] == ("native" if native.available() else "python")
    if workload == "self_adaptive":
        assert info["r_max"] == int(got["sr"].max()) >= 10


def test_strain_resumes_from_the_example_table(pairs):
    d, data = pairs
    pair = data["shift"]
    grid = CASES["fftcc_icgn1"][1]
    prefix = str(d / "resume")
    dic_2d.run("fftcc_icgn1", pair["ref"], pair["tar"], prefix, CPU,
               grid=grid)
    table = f"{prefix}_fftcc_icgn1.csv"
    out, timer = dic_2d.run("strain", table, None, prefix, CPU)
    jt = jtable.load_table_2d(table)
    js = oc.Strain(subregion_radius=20.0, neighbor_number_min=5)
    js.prepare(jt)
    want = np.asarray(js.compute(jt).e)
    np.testing.assert_allclose(out.e.numpy(), want, rtol=0, atol=1e-5)
    assert (np.abs(want).sum(1) > 0).mean() > 0.9
    assert timer.names == ["Strain calculation"]
    for name in ("_strain_r20.csv", "_eyy.csv", "_strain_r20_time.csv"):
        assert os.path.exists(prefix + name)


def test_own_sift_and_missing_reference(pairs, monkeypatch):
    """The feature workload with the port's own SIFT2D, and the reference
    datasets' absence named."""
    d, data = pairs
    pair = data["rotate"]
    grid = CASES["sift_icgn2"][1]
    info = {}
    out, _ = dic_2d.run("sift_icgn2", *pair["paths"], str(d / "own"), CPU,
                        grid=grid, stats=info)
    z = out.zncc.numpy()
    assert info["sift2d_octaves"] and (z > 0.9).mean() > 0.9
    monkeypatch.setenv("OPENCORR_REFERENCE_DIR", str(d / "absent"))
    with pytest.raises(FileNotFoundError, match="rotation_170.tif"):
        dic_2d.run("sift_iclm2", device=CPU)
    monkeypatch.delenv("OPENCORR_REFERENCE_DIR")
    with pytest.raises(FileNotFoundError, match="OPENCORR_REFERENCE_DIR"):
        dic_2d.run("strain", device=CPU)


def test_stage_timer_csv_matches_jax(tmp_path):
    names = ["FFTCC", "ICGN", "Feature extraction and matching"]
    secs = [0.123456789, 2.5, 3.0000000001e-05]
    paths = []
    for cls in (JaxStageTimer, ot.StageTimer):
        t = cls()
        t.names, t.seconds = list(names), list(secs)
        paths.append(tmp_path / f"{cls.__module__}.csv")
        t.save_csv(str(paths[-1]), 30000)
        assert t.report() == JaxStageTimer.report(t)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    t = ot.StageTimer()
    with t.stage("a stage"):
        torch.ones(4).sum()
    assert t.names == ["a stage"] and t.seconds[0] >= 0


def test_native_table_codec(tmp_path, monkeypatch):
    """The native writer's table equals the Python writer's byte for byte
    on finite values and reads back as numpy reads it; the points files
    round-trip."""
    assert native.available()
    rng = np.random.default_rng(7)
    n = 300
    p = rng.normal(0, 3, (n, 12)).astype(np.float32)
    p[:5, 0] = [0.0, -0.0, 2.0 ** -9, 1e6 + 0.5, -123.456789]
    t = ot.table_from_numpy(rng.uniform(0, 900, n), rng.uniform(0, 300, n),
                            p, rng.normal(0, 1, (n, 6)),
                            rng.normal(0, 1e-3, (n, 3)),
                            rng.integers(8, 40, (n, 2)), device=CPU)
    nat, py = str(tmp_path / "native.csv"), str(tmp_path / "python.csv")
    ot.save_table_2d(nat, t)
    ot.save_deformation_table_2d(nat + ".def", t)
    monkeypatch.setattr(native, "write_table", lambda *a, **k: False)
    ot.save_table_2d(py, t)
    ot.save_deformation_table_2d(py + ".def", t)
    for a, b in ((nat, py), (nat + ".def", py + ".def")):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    raw_native = ttable._read_csv(nat, ",")
    monkeypatch.setattr(native, "read_table", lambda *a, **k: None)
    np.testing.assert_array_equal(raw_native, ttable._read_csv(nat, ","))
    back = ot.load_table_2d(nat, device=CPU)
    np.testing.assert_array_equal(back.x.numpy(), t.x.numpy())
    pts = rng.uniform(0, 500, (20, 3)).astype(np.float32)
    ot.save_points_2d(str(tmp_path / "p2.csv"), pts)
    # savePoint2D ends each row with the delimiter, which reads back as a
    # third, empty column in both packages
    np.testing.assert_allclose(
        ot.load_points_2d(str(tmp_path / "p2.csv"))[:, :2], pts[:, :2],
        rtol=0, atol=5e-6)
    np.testing.assert_array_equal(
        ot.load_points_2d(str(tmp_path / "p2.csv")),
        jtable.load_points_2d(str(tmp_path / "p2.csv")))
    np.savetxt(tmp_path / "p3.csv", pts, delimiter=",", fmt="%.8f")
    np.testing.assert_array_equal(ot.load_points_3d(str(tmp_path / "p3.csv")),
                                  jtable.load_points_3d(
                                      str(tmp_path / "p3.csv")))
