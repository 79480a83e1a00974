"""The affine frame generator: seeded, the same set of fields for every
seed, and each target showing the field its parameters impose."""

import numpy as np
import pytest

from generators import affine

MIX2 = {"targets": 4, "translation": [2.0, 2.0],
        "strain": {"range": [0.0, 0.005], "axes": [1.0, 1.0]},
        "speckle": {"sigma": 1.5, "mean": 128.0, "std": 28.0}}
MIX3 = {"targets": 3, "translation": [1.0, 1.0, 1.0],
        "strain": {"range": [0.0, 0.005], "axes": [0.0, 0.0, -1.0]},
        "speckle": {"sigma": 1.5, "mean": 128.0, "std": 20.0}}


@pytest.mark.parametrize("shape, mix", [((40, 36), MIX2),
                                        ((20, 16, 12), MIX3)])
def test_frames_repeat_for_a_seed_and_differ_across_seeds(shape, mix):
    a = affine.make_sequence(shape, mix, 2 ** 31 + 11, "cpu")
    b = affine.make_sequence(shape, mix, 2 ** 31 + 11, "cpu")
    c = affine.make_sequence(shape, mix, 7, "cpu")
    assert a.reference.dtype == np.uint8 and a.reference.shape == shape
    assert len(a.targets) == mix["targets"]
    assert np.array_equal(a.reference, b.reference)
    assert all(np.array_equal(x, y) for x, y in zip(a.targets, b.targets))
    assert not np.array_equal(a.reference, c.reference)


def test_every_seed_gets_the_same_set_of_fields():
    t1, s1 = affine.field_parameters(MIX2, 2, 1)
    t2, s2 = affine.field_parameters(MIX2, 2, 2 ** 31 + 3)
    for a in range(2):
        assert np.allclose(np.sort(t1[:, a]), np.sort(t2[:, a]))
    assert np.allclose(np.sort(s1[:, 0]), np.sort(s2[:, 0]))
    assert np.abs(t1).max() < 2.0 and s1.min() > 0 and s1.max() < 0.005
    t3, s3 = affine.field_parameters(MIX3, 3, 5)
    assert np.all(s3[:, :2] == 0) and np.all(s3[:, 2] < 0)


def _mix(translation, strain, axes):
    return {"targets": 1, "translation": translation,
            "strain": {"range": [strain, strain], "axes": axes},
            "speckle": {"sigma": 1.5, "mean": 128.0, "std": 28.0}}


def test_integer_translation_moves_the_texture_by_that_many_pixels():
    mix = _mix([0.0, 0.0], 0.0, [1.0, 1.0])
    mix["translation"] = [0.0, 0.0]
    seq = affine.make_sequence((30, 40), mix, 3, "cpu")
    assert np.array_equal(seq.targets[0], seq.reference)
    trans, _ = affine.field_parameters(dict(mix, targets=2,
                                            translation=[6.0, 0.0]), 2, 3)
    assert sorted(trans[:, 0]) == [-3.0, 3.0]
    seq = affine.make_sequence((30, 40), dict(mix, targets=2,
                                              translation=[6.0, 0.0]), 3,
                               "cpu")
    for k, t in enumerate(seq.translations[:, 0]):
        s = int(t)
        tar = seq.targets[k].astype(int)
        ref = seq.reference.astype(int)
        # target at x shows the reference at x - t
        if s > 0:
            assert np.array_equal(tar[:, s:], ref[:, :-s])
        else:
            assert np.array_equal(tar[:, :s], ref[:, -s:])


def test_strain_scales_the_texture_about_the_centre():
    # strain 1 doubles distances from the centre of an odd-sized frame
    mix = _mix([0.0, 0.0], 1.0, [1.0, 0.0])
    seq = affine.make_sequence((21, 41), mix, 4, "cpu")
    assert np.allclose(seq.strains[0], [1.0, 0.0])
    c = 20
    tar, ref = seq.targets[0], seq.reference
    for k in range(-10, 11):
        assert np.array_equal(tar[:, c + 2 * k], ref[:, c + k])
    pts = np.array([[c + 5.0, 3.0]])
    assert np.allclose(seq.displacement(0, pts), [[5.0, 0.0]])
