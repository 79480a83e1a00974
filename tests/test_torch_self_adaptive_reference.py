"""The port's self-adaptive-subset program against the benchmark's plain
reference on the CPU: SIFT2D -> self-adaptive FeatureAffine2D ->
ICGN2D1 on each POI's radii -> Strain, chained by the benchmark's
pipeline (``benchmark/pipelines/dic2d_self_adaptive.py``) in float32,
against ``benchmark/reference/self_adaptive.py`` in float64, on one
seeded 80 x 448 pair stretched 0.5% along x with 390 POIs.  Also: every
read of a device value on this path goes through ``timing.host_read``.

Tolerances, each from the float32 arithmetic of one side:

* matched keypoints: the program's 979 pairs are among the reference's
  980, positions within 1e-3 px (the float32 pyramid moves a sub-pixel
  offset by about 1e-5, and a position rounds to float32 like OpenCV's
  ``KeyPoint.pt``);
* adapted subsets (x, y, srx, sry) and codes: equal;
* u, v within 1e-4 px and their gradients within 1e-5 (float32 LUT
  samples against float64 B-spline sums over at most 10 steps: 2e-5 and
  2e-6 measured);
* strain within 1e-6 (least squares over about 26 POIs of those
  displacements: 1e-7 measured).
"""

import collections
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import opencorr_tpu_torch as ot
from opencorr_tpu_torch.utils import timing

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from core.spec import Spec  # noqa: E402
from core.cell import Spans  # noqa: E402

torch.set_num_threads(1)

SHAPE = [80, 448]
GRID = {"upper_left": [30, 30], "number_x": 78, "number_y": 5, "step": 5}
SEED = 2 ** 31 + 57


@pytest.fixture(scope="module")
def cell():
    spec = Spec(BENCH.parent)
    c = spec.cell("dic2d_self_adaptive.seq")
    cfg = dict(spec.config(c["config"]), frame_shape=SHAPE, poi_grid=GRID)
    mix = dict(spec.traffic(c["traffic"]), targets=2,
               strain={"range": [0.005, 0.005], "axes": [1.0, 0.0]})
    seq = spec.generator(mix["generator"]).make_sequence(SHAPE, mix, SEED,
                                                         "cpu")
    return spec.pipeline(cfg["pipeline"]), cfg, seq


# the Tensor methods that read a device value to the host
READS = ("__bool__", "__int__", "__float__", "__index__", "__array__",
         "item", "tolist", "cpu", "numpy")
PKG = str(Path(ot.__file__).resolve().parent)
TIMING = str(Path(timing.__file__).resolve())


def _reads_outside_host_read(stray: collections.Counter):
    """Tensor methods that count, in ``stray``, each read of a device
    value made in the port's files outside ``timing.host_read``."""
    def wrap(method):
        original = getattr(torch.Tensor, method)

        def read(self, *args, **kwargs):
            frame = sys._getframe(1)
            if frame.f_code.co_filename.startswith(PKG):
                via = frame
                while via is not None and not (
                        via.f_code.co_filename == TIMING
                        and via.f_code.co_name == "host_read"):
                    via = via.f_back
                if via is None:
                    stray[f"{Path(frame.f_code.co_filename).name}:"
                          f"{frame.f_lineno} {method}"] += 1
            return original(self, *args, **kwargs)

        return read

    return {method: wrap(method) for method in READS}


@pytest.fixture(scope="module")
def results(cell):
    """(the program's table, its matched keypoints, the reference's
    result, the program's reads outside ``host_read``, its counters)."""
    pipe, cfg, seq = cell
    program = pipe.Pipeline(cfg, "cpu")
    program.setup(seq.reference)
    kept, stray = {}, collections.Counter()
    original = ot.FeatureAffine2D.set_keypoint_pair

    def spy(self, ref_kp, tar_kp):
        kept["ref"], kept["tar"] = np.asarray(ref_kp), np.asarray(tar_kp)
        return original(self, ref_kp, tar_kp)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ot.FeatureAffine2D, "set_keypoint_pair", spy)
        for method, read in _reads_outside_host_read(stray).items():
            mp.setattr(torch.Tensor, method, read)
        before = timing.counts()
        out = program.pair(seq.targets[0], Spans())
        counts = timing.counts()
    counts.subtract(before)
    ref = pipe.reference(cfg, seq.reference, seq.targets[0], "cpu")
    return out, kept, ref, stray, +counts


def test_matched_keypoints_equal_the_reference(results):
    _, kept, ref = results[:3]
    mine = np.concatenate([kept["ref"], kept["tar"]], 1).astype(np.float64)
    plain = np.concatenate([ref["ref_kp"], ref["tar_kp"]], 1)
    gap = np.abs(mine[:, None, :] - plain[None, :, :]).max(-1)
    # every match of the program is one of the reference's, and the
    # reference has one more: an orientation peak of a target keypoint
    # that float32 rounding leaves below 0.8 of its histogram's maximum
    assert (gap.min(1) < 1e-3).all()
    assert len(mine) == 979 and len(plain) == 980
    assert (gap.min(0) < 1e-3).sum() == 979


def test_adapted_subsets_and_codes_equal_the_reference(results):
    out, _, ref = results[:3]
    np.testing.assert_array_equal(out["r"][:, 6:10], ref["seed"])
    assert (ref["seed"][:, 2:] >= 10).all()
    np.testing.assert_array_equal(out["r"][:, 2] < 0, ref["zncc"] < 0)
    np.testing.assert_array_equal(np.minimum(out["r"][:, 2], 0),
                                  np.minimum(ref["zncc"], 0))
    assert (ref["zncc"] > 0.99).mean() > 0.95


def test_displacements_and_gradients_within_float32(results):
    out, _, ref = results[:3]
    ok = ref["zncc"] >= 0
    uv = out["p"][:, [0, 6]].astype(np.float64)
    grads = out["p"][:, [1, 2, 7, 8]].astype(np.float64)
    np.testing.assert_allclose(uv[ok], ref["p"][ok][:, [0, 3]], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(grads[ok], ref["p"][ok][:, [1, 2, 4, 5]],
                               rtol=0, atol=1e-5)
    assert abs(ref["p"][ok][:, 1].mean() - 0.005) < 1e-4


def test_strain_within_float32(results):
    out, _, ref = results[:3]
    np.testing.assert_allclose(out["e"], ref["strain"], rtol=0, atol=1e-6)
    assert abs(ref["strain"][:, 0].mean() - 0.005) < 1e-4


def test_every_host_read_of_the_path_goes_through_host_read(results):
    stray, counts = results[3:]
    assert not stray, stray
    sites = {k for k in counts if ".sync." in k}
    assert {"sift2d.sync.candidates", "sift2d.sync.keep",
            "feature_affine.sync.codes", "icgn.sync.radius",
            "icgn.sync.active"} <= sites, sites


def test_sift2d_keeps_every_keypoint_past_its_caps(cell, monkeypatch):
    """Caps far below this pair's counts grow the octaves' buffers: the
    same keypoints are matched, in the same order, as under the caps the
    octaves' sizes set (which this pair does not reach)."""
    from opencorr_tpu_torch.ops import sift2d as sift_ops

    _, _, seq = cell
    ref = ot.Image2D.from_array(seq.reference)
    tar = ot.Image2D.from_array(seq.targets[0])

    def matched():
        sift = ot.SIFT2D(backend="device", device="cpu")
        sift.set_images(ref, tar)
        sift.compute()
        return sift

    own = matched()
    assert own.stats["cap_hits"] == 0
    monkeypatch.setattr(sift_ops, "octave_caps", lambda hh, ww, n: (64, 128))
    small = matched()
    assert small.stats["cap_hits"] >= 6
    assert small.stats["keypoints"] == own.stats["keypoints"] > 1000
    np.testing.assert_array_equal(small.ref_matched_kp, own.ref_matched_kp)
    np.testing.assert_array_equal(small.tar_matched_kp, own.tar_matched_kp)
