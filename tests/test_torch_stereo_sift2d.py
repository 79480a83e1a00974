"""The port's SIFT2D and FeatureAffine2D against the JAX package on the CPU.

SIFT2D: the blurs (the JAX package's on XLA's CPU convolution, the port's
as float64 tap sums rounded once) agree within 1e-6 x 255 but not bit for
bit, so the detection stages are held on the JAX package's own pyramid:
per-octave candidate, keypoint and instance counts equal, positions within
1e-4 px, descriptor entries within 1 unit.  From the image, the whole
detection agrees as far as the last-bit blur differences allow: per-octave
instance counts within 2% (a keypoint or an orientation peak at a
threshold can flip) and the common keypoints within 1e-3 px (the subpixel
fit amplifies the blur's rounding).  Matching on the same descriptors is
equal, ties included.

FeatureAffine2D with the JAX package's own draws
(jax.random.randint(PRNGKey(seed), (3, N, T), 0, 2^30), as
``_ransac_core_2d`` draws them): codes, iteration and feature counts equal,
p6 within 1e-5."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from scipy.ndimage import shift as ndshift
from scipy.spatial import cKDTree

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu.models import feature_affine as jfa
from opencorr_tpu.models import sift2d as jsift_mod
from opencorr_tpu.ops import feature_affine as jops
from opencorr_tpu.ops import sift2d as jsift
from opencorr_tpu_torch.data import poi as tpoi
from opencorr_tpu_torch.models import sift2d as tsift_mod
from opencorr_tpu_torch.ops import feature_affine as tops
from opencorr_tpu_torch.ops import sift2d as tsift

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

SIGMA, LAYERS = 1.6, 3


def _speckle(shape, seed, sigma=1.5):
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.standard_normal(shape), sigma)
    return np.clip(np.round(img / img.std() * 28 + 128), 0, 255).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_octaves():
    """The JAX package's pyramid and per-octave detection of a 96x80
    speckle image (the calls ``detect_and_compute`` makes)."""
    img = _speckle((96, 80), seed=3)
    sigmas = tuple(jsift.octave_sigmas(SIGMA, LAYERS))
    r_ori, r_desc = jsift.radius_caps(SIGMA, LAYERS)
    cur = jsift.build_base(jnp.asarray(img), sigma=SIGMA)
    octaves = []
    for o in range(jsift.n_octaves_for(img.shape)):
        hh, ww = cur.shape
        if min(hh, ww) < 2 * jsift.IMG_BORDER + 2:
            break
        gauss, dog = jsift.build_octave(cur, sigmas=sigmas)
        k_raw, k_kp = tsift.octave_caps(hh, ww, LAYERS)
        kw = dict(n_layers=LAYERS, contrast_thr=0.04, edge_thr=10.0,
                  sigma=SIGMA, k_raw=k_raw, k_kp=k_kp, radius_ori=r_ori,
                  radius_desc=r_desc)
        out = jax.device_get(jsift.detect_octave(gauss, dog, **kw))
        octaves.append(dict(base=np.array(cur), gauss=np.array(gauss),
                            dog=np.array(dog), kw=kw, out=out))
        cur = gauss[LAYERS][::2, ::2]
    return img, octaves


def test_octave_caps_and_sigmas_match_jax():
    for shape in ((96, 80), (2400, 3840), (1200, 1920), (30, 20)):
        assert tsift.n_octaves_for(shape) == jsift.n_octaves_for(shape)
    assert tsift.octave_sigmas(SIGMA, LAYERS) == jsift.octave_sigmas(SIGMA,
                                                                     LAYERS)
    assert tsift.radius_caps(SIGMA, LAYERS) == jsift.radius_caps(SIGMA, LAYERS)


def test_pyramid_matches_jax(jax_octaves):
    """The base (u8 round, 2x bilinear upscale with half-pixel centres,
    pre-blur) and each octave's Gaussian and DoG stacks within 1e-6 x 255
    grey levels of the JAX package's."""
    img, octaves = jax_octaves
    base = tsift.build_base(torch.from_numpy(img), sigma=SIGMA)
    np.testing.assert_allclose(base.numpy(), octaves[0]["base"], rtol=0,
                               atol=255e-6)
    up = tsift.upscale2x(torch.from_numpy(img))
    want = np.asarray(jax.image.resize(jnp.asarray(img), (192, 160),
                                       "linear"))
    np.testing.assert_array_equal(up.numpy(), want)
    sigmas = tuple(tsift.octave_sigmas(SIGMA, LAYERS))
    for o in octaves[:2]:
        g, d = tsift.build_octave(torch.from_numpy(o["base"]), sigmas=sigmas)
        np.testing.assert_allclose(g.numpy(), o["gauss"], rtol=0,
                                   atol=255e-6)
        np.testing.assert_allclose(d.numpy(), o["dog"], rtol=0, atol=255e-6)


def test_detect_octave_on_jax_pyramid(jax_octaves):
    """Extrema, refinement, orientation peaks and descriptors on the JAX
    package's own pyramid."""
    _, octaves = jax_octaves
    seen = 0
    for o in octaves:
        got, counts = tsift.detect_octave(torch.from_numpy(o["gauss"]),
                                          torch.from_numpy(o["dog"]),
                                          **o["kw"])
        want = o["out"]
        ok_w, ok_g = np.asarray(want[0]), got[0].numpy()
        np.testing.assert_array_equal(ok_g, ok_w)
        assert counts["instances"] == ok_w.sum()
        if o is octaves[0]:
            thr = math.floor(0.5 * 0.04 / LAYERS * 255)
            mask = jax.jit(jsift._extremum_mask, static_argnums=(1, 2))(
                jnp.asarray(o["dog"]), thr, LAYERS)
            got_mask = tsift.extremum_mask(torch.from_numpy(o["dog"]), thr,
                                           LAYERS)
            np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
            assert counts["candidates"] == int(mask.sum())
        if not ok_w.any():
            continue
        seen += int(ok_w.sum())
        for i, tol in ((1, 1e-4), (2, 1e-4), (3, 1e-4), (4, 1e-4),
                       (5, 1e-6), (6, 1e-3)):
            np.testing.assert_allclose(got[i].numpy()[ok_g],
                                       np.asarray(want[i])[ok_w], rtol=0,
                                       atol=tol)
        dd = np.abs(got[7].numpy()[ok_g] - np.asarray(want[7])[ok_w])
        assert dd.max() <= 1.0
    assert seen > 100


def _keypoints(results):
    """(octave, x, y) of every valid instance, in input-image pixels."""
    rows = []
    for r in results:
        ok = np.asarray(r[0]) if not torch.is_tensor(r[0]) else r[0].numpy()
        f = 2.0 ** (r[8] - 1)
        x = np.asarray(r[1]) if not torch.is_tensor(r[1]) else r[1].numpy()
        y = np.asarray(r[2]) if not torch.is_tensor(r[2]) else r[2].numpy()
        rows.append(np.stack([np.full(ok.sum(), r[8]), x[ok] * f,
                              y[ok] * f], -1))
    return np.concatenate(rows)


def test_detect_and_compute_end_to_end(jax_octaves):
    img, octaves = jax_octaves
    res, counts = tsift.detect_and_compute(torch.from_numpy(img))
    assert len(res) == len(octaves)
    for o, (c, jo) in enumerate(zip(counts, octaves)):
        n_j = int(np.asarray(jo["out"][0]).sum())
        assert c["octave"] == o and c["k_kp"] == jo["kw"]["k_kp"]
        assert abs(c["instances"] - n_j) <= max(2, 0.02 * n_j)
    kp_t = _keypoints(res)
    kp_j = _keypoints([o["out"] + (i,) for i, o in enumerate(octaves)])
    common = 0
    for o in np.unique(kp_j[:, 0]):
        a, b = kp_j[kp_j[:, 0] == o, 1:], kp_t[kp_t[:, 0] == o, 1:]
        if not len(a) or not len(b):
            continue
        d, _ = cKDTree(b).query(a)
        near = d < 1e-2
        common += near.sum()
        assert (d[near] < 1e-3).all()
    assert common >= 0.98 * len(kp_j)


def test_match_device_matches_jax(jax_octaves):
    """The exact 2-NN ratio test on the same descriptors: equal keeps and
    indices, with exact duplicates (ties) among the targets."""
    _, octaves = jax_octaves
    out = octaves[0]["out"]
    desc = np.asarray(out[7])[np.asarray(out[0])]
    rng = np.random.default_rng(2)
    tar = desc[rng.permutation(len(desc))].copy()
    tar[::5] = np.clip(tar[::5] + rng.integers(-6, 7, tar[::5].shape), 0,
                       255)
    tar = np.concatenate([tar, tar[:20]])  # ties: the lower index wins
    n1, n2 = len(desc), len(tar)
    pad = lambda a: np.pad(a, ((0, 2048 - len(a)), (0, 0)))
    r, t = pad(desc.astype(np.float32)), pad(tar.astype(np.float32))
    r_ok, t_ok = np.arange(2048) < n1, np.arange(2048) < n2
    kj, ij = jsift.match_device(jnp.asarray(r), jnp.asarray(r_ok),
                                jnp.asarray(t), jnp.asarray(t_ok),
                                jnp.float32(0.8))
    kt, it = tsift.match_device(torch.from_numpy(r), torch.from_numpy(r_ok),
                                torch.from_numpy(t), torch.from_numpy(t_ok),
                                0.8, chunk=512)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    keep = np.asarray(kj)
    np.testing.assert_array_equal(it.numpy()[keep], np.asarray(ij)[keep])
    assert 0 < keep.sum() < n1


def test_sift2d_module_matches_and_retain_best():
    """SIFT2D on a translated pair: the matched keypoints move by the
    shift; the retain-best path keeps the n strongest responses as the
    JAX package's ``_retain_best``; backend="opencv" is a module of its
    own (test_sift2d_opencv_matches_jax)."""
    img = _speckle((88, 96), seed=8)
    tar = np.clip(np.round(ndshift(img, (1.4, -2.3), order=3)), 0, 255)
    s = ot.SIFT2D(device="cpu")
    s.set_images(img, tar)
    s.prepare()
    s.compute()
    d = s.tar_matched_kp - s.ref_matched_kp
    assert len(d) > 40
    np.testing.assert_allclose(np.median(d, 0), (-2.3, 1.4), atol=0.05)
    assert {st["image"] for st in s.octave_stats} == {"ref", "tar"}
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 90, (50, 2)).astype(np.float32)
    desc = rng.integers(0, 255, (50, 128)).astype(np.float32)
    resp = np.round(rng.uniform(0, 1, 50), 2).astype(np.float32)  # ties
    for a, b in zip(tsift_mod._retain_best(pts, desc, resp, 20),
                    jsift_mod._retain_best(pts, desc, resp, 20)):
        np.testing.assert_array_equal(a, b)
    s.sift_config.n_features = 60
    s.compute()
    assert 0 < len(s.ref_matched_kp) <= 60
    cv = ot.SIFT2D(backend="opencv", device="cpu")
    assert cv.backend == "opencv" and s.backend == "device"


def test_sift2d_opencv_matches_jax():
    """backend="opencv": OpenCV's detector, then each package's exact
    device match; equal matched keypoints.  Without cv2 the port raises
    ImportError naming it."""
    img = _speckle((88, 96), seed=8)
    tar = np.clip(np.round(ndshift(img, (1.4, -2.3), order=3)), 0, 255)
    t = ot.SIFT2D(backend="opencv", device="cpu")
    t.set_images(img, tar)
    try:
        import cv2  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="cv2"):
            t.compute()
        pytest.skip("cv2 is not installed")
    j = jsift_mod.SIFT2D(backend="opencv")
    j.set_images(img, tar)
    j.compute()
    t.compute()
    np.testing.assert_array_equal(t.ref_matched_kp, j.ref_matched_kp)
    np.testing.assert_array_equal(t.tar_matched_kp, j.tar_matched_kp)
    assert len(t.ref_matched_kp) > 20
    d = np.median(t.tar_matched_kp - t.ref_matched_kp, 0)
    np.testing.assert_allclose(d, (-2.3, 1.4), atol=0.05)


# --- FeatureAffine2D --------------------------------------------------------


def _affine_kp(n=400, seed=1, noise=0.0, outliers=0):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(10, 250, (n, 2)).astype(np.float32)
    a = (np.eye(2) + rng.normal(0, 0.01, (2, 2))).astype(np.float32)
    t = np.array([3.5, -2.0], np.float32)
    tar = ref @ a + t + rng.normal(0, noise, (n, 2)).astype(np.float32)
    if outliers:
        tar[:outliers] += rng.uniform(4, 15, (outliers, 2)).astype(np.float32)
    return ref, tar, a, t


def _queries(seed=3, n=300):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 260, (n, 2))
    q[:10] = rng.uniform(400, 500, (10, 2))  # far away: too few in reach
    return q


@pytest.mark.parametrize("noise,outliers,seed", [(0.0, 0, 0), (0.3, 60, 5),
                                                 (0.8, 120, 11)])
def test_ransac_2d_with_jax_draws(noise, outliers, seed):
    ref, tar, _, _ = _affine_kp(noise=noise, outliers=outliers)
    q = _queries().astype(np.float32)
    idx, cand, enough = jfa._host_candidates(cKDTree(ref), q.astype(
        np.float64), 128, 22.63, 7, 3)
    trials = 20
    want = jops.feature_affine_2d_idx(
        jnp.asarray(ref), jnp.asarray(tar), jnp.asarray(q[:, 0]),
        jnp.asarray(q[:, 1]), jnp.asarray(idx), jnp.asarray(cand),
        jnp.asarray(enough), jnp.float32(7), jnp.float32(1.5),
        jnp.int32(seed), trials=trials, samples=3)
    draws = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                          (3, len(q), trials), 0, 1 << 30))
    t = lambda a: torch.from_numpy(np.array(a))
    got = tops.feature_affine_2d_idx(
        t(ref), t(tar), t(q[:, 0]), t(q[:, 1]), t(idx), t(cand), t(enough),
        7, 1.5, t(draws), trials=trials, samples=3)
    p_w, z_w, it_w, f_w, ok_w = (np.asarray(a) for a in want)
    p_g, z_g, it_g, f_g, ok_g = (a.numpy() for a in got)
    np.testing.assert_array_equal(ok_g, ok_w)
    np.testing.assert_array_equal(z_g, z_w)
    np.testing.assert_array_equal(it_g, it_w)
    np.testing.assert_array_equal(f_g, f_w)
    np.testing.assert_allclose(p_g, p_w, rtol=0, atol=1e-5)
    assert (z_g == -1).any() and ok_g.mean() > 0.5


def test_fa2d_module_with_jax_draws_equals_jax_module():
    """FeatureAffine2D with the JAX package's draws reproduces the JAX
    module's table (one chunk, so its draws are those of PRNGKey(seed));
    the port's own draws recover the exact affine field."""
    ref, tar, a, t = _affine_kp(noise=0.2, outliers=40)
    pois = oc.poi_grid_2d((20, 20), 12, 10, 20)
    jm = oc.FeatureAffine2D(16, 16, seed=4)
    jm.set_keypoint_pair(ref, tar)
    jt = jm.compute(pois)
    fa = ot.FeatureAffine2D(16, 16, seed=4, device="cpu")
    fa.set_keypoint_pair(ref, tar)
    tt = ot.poi_grid_2d((20, 20), 12, 10, 20, device="cpu")
    draws = jax.random.randint(jax.random.PRNGKey(4), (3, tt.n, 20), 0,
                               1 << 30)
    got = fa.compute(tt, draws=torch.from_numpy(np.array(draws)))
    np.testing.assert_array_equal(got.r.numpy(), np.asarray(jt.r))
    np.testing.assert_allclose(got.p.numpy(), np.asarray(jt.p), rtol=0,
                               atol=1e-5)
    assert (got.zncc.numpy() == 0).mean() > 0.8
    ref, tar, a, t = _affine_kp()
    fa.set_keypoint_pair(ref, tar)
    out = fa.compute(tt)
    ok = out.zncc.numpy() == 0
    xy = np.stack(out.xy_numpy(), -1)
    exp = xy @ a + t - xy
    assert ok.mean() > 0.8
    np.testing.assert_allclose(out.p.numpy()[ok][:, [tpoi.U, tpoi.V]],
                               exp[ok], atol=2e-2)
    fa.set_self_adaptive(True)  # ported: tests/test_torch_adaptive.py
    assert fa.self_adaptive
