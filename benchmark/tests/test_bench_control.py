"""The control of ``correct`` on the card: the plain reference computed in
float32 with TF32 matrix products on (the precision below the
configurations' float32 with TF32 off), put in the program's place, must
break a limit of its cell.  The 2D cell at its own size on two targets;
the DVC cell at its frame size on the POIs of its first four z-levels.
Run on the card with
``python -m pytest -q -p no:cacheprovider -m cuda benchmark/tests``."""

import pytest
import torch

import calibrate
from conftest import ROOT
from core import check
from core.spec import Spec
from reference.common import matmul_precision


@pytest.mark.cuda
@pytest.mark.parametrize("cell, layers", [("dic2d_fftcc_icgn1.seq", None),
                                          ("dvc_fftcc_icgn1.seq", 4)])
def test_the_control_breaks_a_limit(cuda, cell, layers):
    spec = Spec(ROOT)
    c = spec.cell(cell)
    cfg = spec.config(c["config"])
    if layers is not None:
        cfg["poi_grid"] = dict(cfg["poi_grid"], number_z=layers)
    pipe = spec.pipeline(cfg["pipeline"])
    mix = spec.traffic(c["traffic"])
    seq = spec.generator(mix["generator"]).make_sequence(
        cfg["frame_shape"], mix, 2 ** 31 + 77, cuda)
    limits = cfg["check"]["limits"]
    for tar in seq.targets[:2]:
        ref = pipe.reference(cfg, seq.reference, tar, cuda)
        with matmul_precision(True):
            low = pipe.reference(cfg, seq.reference, tar, cuda, torch.float32)
        got = check.compare(pipe.LAYOUT, calibrate.as_table(pipe.LAYOUT, low),
                            ref)
        assert any(got[k] > lim for k, lim in limits.items()), got
        same = check.compare(pipe.LAYOUT,
                             calibrate.as_table(pipe.LAYOUT, ref), ref)
        assert all(same[k] <= lim for k, lim in limits.items()), same
