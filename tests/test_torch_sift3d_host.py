"""The port's SIFT3D host path (``pyramid_backend="host"``, the default of
both packages) against the JAX package's on the CPU.

* The blur equals scipy's ``convolve1d(..., mode="mirror")`` (the JAX host
  blur) bit for bit, and every pyramid layer equals the JAX host path's in
  float32.
* Keypoints (every extremum, no caps) and matched sets equal, in both
  match modes.
* Orientation: rotations within 1e-5 of the JAX package's (the structure
  tensor's sums are taken in another order).  That float32 noise, about
  1e-6, moves a few keypoints' descriptors by up to about 4e-3 x max
  (voxels cross the cube's edge or a tent bin), so the descriptor stage is
  held on the JAX package's own rotations: every keypoint within 1e-5 x
  the largest descriptor entry, on layers that take kernel 4's plain
  version and on layers that take the einsum path.
* On a volume whose z extent caps the descriptor window (r_cap) and whose
  voxels are twice as deep as wide, one layer's window no longer holds the
  descriptor sphere: kernel 4's box there sees other voxels near a face
  (differs from the JAX package beyond the gate), so the port routes that
  layer to the einsum path, which agrees.
* ``_top2_distances`` orders equal distances lower index first, as
  ``jax.lax.top_k``.

The 52^3 pair is tests/test_torch_sift3d_pipeline.py's; the JAX host path
takes about 20 s on it here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift as ndshift

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu.models import sift3d as jmodel
from opencorr_tpu.ops import sift3d as jops
from opencorr_tpu_torch.models import sift3d as tmodel
from opencorr_tpu_torch.ops import desc3d
from opencorr_tpu_torch.ops import sift3d as tops

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

SHIFT_ZYX = (2.0, -1.0, 1.5)
# a volume whose z extent caps r_desc (r_cap 14), with voxels twice as
# deep as wide
SMALL_SHAPE = (30, 48, 48)
SMALL_UNITS = (1.0, 1.0, 2.0)


def _pair(shape, seed=2, sigma=1.5):
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.standard_normal(
        tuple(d + 20 for d in shape)).astype(np.float32), sigma) * 50 + 128
    crop = tuple(slice(10, 10 + d) for d in shape)
    ref = base[crop]
    tar = ndshift(base, SHIFT_ZYX, order=3)[crop]
    return np.ascontiguousarray(ref), np.ascontiguousarray(tar)


def _run(shape, units):
    """Both packages' host paths on one pair: JAX's and the port's
    pyramids, keypoints and descriptors of each volume, the JAX package's
    rotations of every (octave, layer) group, and the port module."""
    ref, tar = _pair(shape)
    j = oc.SIFT3D()
    t = ot.SIFT3D(device="cpu")
    for m in (j, t):
        m.set_physical_unit(*units)
    out = dict(j=j, t=t, vols=(ref, tar), jax=[], port=[])
    for vol in (ref, tar):
        jl = j._gaussian_pyramid(vol)
        kp, desc = j._extract(vol)
        rots = {}
        cfg = j.sift_config
        for m in range(cfg.n_octave):
            for n in range(1, cfg.n_octave_layers + 1):
                sel = (kp[:, 3] == m) & (kp[:, 4] == n)
                if not sel.any():
                    continue
                g = jl[m * (cfg.n_octave_layers + 3) + n]
                grp = np.concatenate([kp[sel, :3] / 2 ** m, kp[sel, 3:5]],
                                     1).astype(np.int32)
                r_o = t._radii(g)[0]
                rot, _ = jmodel._run_chunked(
                    jops.assign_orientation, np.asarray(g.vol), grp, r_o,
                    j.kp_chunk_budget,
                    extra=(jnp.float32(g.scale),
                           jnp.asarray(np.array(g.units, np.float32)),
                           jnp.float32(cfg.gradient_threshold),
                           jnp.float32(cfg.beta), jnp.float32(cfg.gamma)))
                rots[(m, n)] = rot
        out["jax"].append(dict(layers=[np.asarray(g.vol) for g in jl],
                               kp=kp, desc=desc, rots=rots))
        layers, vols = t._gaussian_pyramid(torch.from_numpy(vol))
        tk, td = t._extract(torch.from_numpy(vol), "v")
        out["port"].append(dict(plan=layers, layers=vols, kp=tk.numpy(),
                                desc=td))
    return out


@pytest.fixture(scope="module")
def run52():
    return _run((52, 52, 52), (1.0, 1.0, 1.0))


@pytest.fixture(scope="module")
def run_small():
    return _run(SMALL_SHAPE, SMALL_UNITS)


@pytest.mark.parametrize("shape,sigma,units", [
    ((20, 22, 24), 1.23, (1.0, 1.0, 1.0)),
    ((9, 8, 30), 2.1, (1.0, 1.0, 1.0)),
    ((5, 40, 6), 1.9, (1.0, 1.0, 1.0)),  # radius 6 > axis length
    ((12, 14, 16), 1.54, (2.0, 2.0, 4.0)),
    ((10, 11, 12), 0.0, (1.0, 1.0, 1.0)),
])
def test_host_blur_equals_scipy(shape, sigma, units):
    rng = np.random.default_rng(shape[0])
    v = rng.uniform(0, 255, shape).astype(np.float32)
    want = jmodel._host_gaussian_blur(v, sigma, units)
    got = tmodel._host_gaussian_blur(torch.from_numpy(v), sigma, units)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("which", ["run52", "run_small"])
def test_host_pyramid_equals_jax(which, request):
    r = request.getfixturevalue(which)
    for jv, pv in zip(r["jax"], r["port"]):
        assert len(jv["layers"]) == len(pv["layers"])
        for a, b in zip(jv["layers"], pv["layers"]):
            np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("which", ["run52", "run_small"])
def test_host_keypoints_equal_jax(which, request):
    r = request.getfixturevalue(which)
    for jv, pv in zip(r["jax"], r["port"]):
        np.testing.assert_array_equal(pv["kp"], jv["kp"])
        assert len(pv["kp"]) > 10
    # no caps on the host path: every candidate oriented, every survivor
    # kept
    for st in r["t"].layer_stats:
        assert st["kept"] == st["oriented"] <= st["candidates"]


@pytest.mark.parametrize("which", ["run52", "run_small"])
def test_host_descriptors_equal_jax_on_its_rotations(which, request):
    """The descriptor stage, fed the JAX package's rotations, within 1e-5 x
    max|desc| of the JAX host path on every keypoint; the port's own
    rotations within 1e-5 of the JAX package's."""
    r = request.getfixturevalue(which)
    t = r["t"]
    routes = set()
    for jv, pv in zip(r["jax"], r["port"]):
        for (m, n), jrot in jv["rots"].items():
            i = m * (t.sift_config.n_octave_layers + 3) + n
            g, vg = pv["plan"][i], pv["layers"][i]
            sel = (jv["kp"][:, 3] == m) & (jv["kp"][:, 4] == n)
            xyz = torch.from_numpy((jv["kp"][sel, :3] / 2 ** m).astype(
                np.int64))
            # only the oriented keypoints are described: JAX's kp holds them
            rot = torch.from_numpy(np.asarray(jrot))
            assert rot.shape[0] == int(sel.sum())
            desc, crop, route = t._describe(vg, g, xyz[:, 0], xyz[:, 1],
                                            xyz[:, 2], rot)
            routes.add(route)
            want = jv["desc"][sel]
            np.testing.assert_allclose(desc.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            # the port's rotations: the same keypoints, float32 noise
            win, x0, y0, z0 = tops.gather_windows_3d(
                vg, xyz[:, 0], xyz[:, 1], xyz[:, 2], t._radii(g)[0])
            prot, ok = tops.assign_orientation(
                win, x0, y0, z0, xyz[:, 0], xyz[:, 1], xyz[:, 2],
                vg.shape[::-1], g.scale, g.units,
                t.sift_config.gradient_threshold, t.sift_config.beta,
                t.sift_config.gamma)
            assert ok.all()
            np.testing.assert_allclose(prot.numpy(), rot.numpy(), rtol=0,
                                       atol=1e-5)
    want_routes = {"run52": {"kernel 4", "plain: crop does not fit"},
                   "run_small": {"plain: window clips the sphere",
                                 "plain: crop does not fit"}}[which]
    assert want_routes <= routes


def test_kernel4_box_differs_where_the_window_clips(run_small):
    """On the layer the port routes to the einsum path, kernel 4's box
    (the sphere within the volume) differs from the JAX host path's window
    near a face by more than the gate, on the JAX package's rotations."""
    t = run_small["t"]
    jv, pv = run_small["jax"][0], run_small["port"][0]
    worst = 0.0
    for (m, n), jrot in jv["rots"].items():
        i = m * (t.sift_config.n_octave_layers + 3) + n
        g, vg = pv["plan"][i], pv["layers"][i]
        _, r_desc = t._radii(g)
        crop = tops._sphere_crop(r_desc, g.scale, g.units)
        if tmodel._descriptor_route(crop, r_desc, g, vg.shape) != \
                "plain: window clips the sphere":
            continue
        sel = (jv["kp"][:, 3] == m) & (jv["kp"][:, 4] == n)
        xyz = torch.from_numpy((jv["kp"][sel, :3] / 2 ** m).astype(np.int64))
        fused = desc3d.describe_keypoints_fused(
            vg, xyz[:, 0], xyz[:, 1], xyz[:, 2],
            torch.from_numpy(np.asarray(jrot)), t.sift_config.truncate_threshold,
            crop=crop, scale=g.scale, unit_xyz=g.units)
        want = jv["desc"][sel]
        worst = max(worst, float(np.abs(fused.numpy() - want).max()
                                 / np.abs(want).max()))
    assert worst > 1e-3


@pytest.mark.parametrize("mode", ["mono", "bi"])
def test_host_matches_equal_jax(run52, mode):
    """The port's matching against the JAX host path's own matching of its
    keypoints and descriptors (what ``oc.SIFT3D.compute`` runs): the whole
    ``compute`` in mono mode, the match of the fixture's extractions in bi
    mode."""
    jr, jt = run52["jax"]
    match = (jmodel._bidirectional_match if mode == "bi"
             else jmodel._monodirectional_match)
    want = match(jr["kp"], jr["desc"], jt["kp"], jt["desc"], 0.85)
    t = ot.SIFT3D(match_mode=mode, device="cpu")
    if mode == "mono":
        t.set_images(*run52["vols"])
        t.compute()
    else:
        pr, pt = run52["port"]
        t._match(torch.from_numpy(pr["kp"]), pr["desc"],
                 torch.from_numpy(pt["kp"]), pt["desc"])
    assert (t.ref_kp_count, t.tar_kp_count) == (len(jr["kp"]), len(jt["kp"]))
    np.testing.assert_array_equal(t.ref_matched_kp, want[0])
    np.testing.assert_array_equal(t.tar_matched_kp, want[1])
    assert len(want[0]) >= 8
    med = np.median(t.tar_matched_kp - t.ref_matched_kp, axis=0)
    for m_, s in zip(med, SHIFT_ZYX[::-1]):
        assert abs(m_ - s) <= 1.0
    assert "match" in t.stage_ms
    if mode == "mono":
        assert {"blur", "dog", "extrema", "orientation",
                "descriptors"} <= set(t.stage_ms)


def test_top2_distances_tie_order():
    rng = np.random.default_rng(7)
    d1 = rng.integers(0, 3, (40, 16)).astype(np.float32)
    d2 = rng.integers(0, 3, (50, 16)).astype(np.float32)
    d2[10:20] = d2[0]  # exact duplicates: equal distances
    dj, ij = jmodel._top2_distances(d1, d2)
    dt, it = tmodel._top2_distances(torch.from_numpy(d1),
                                    torch.from_numpy(d2))
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    assert (dj[:, 0] == dj[:, 1]).any()
