"""The PyTorch port's POI tables, CSV writers, import hygiene and device
rule, against the JAX package on the CPU."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencorr_tpu as oc
import opencorr_tpu_torch as ot
from opencorr_tpu.data import poi as jpoi
from opencorr_tpu.io import table as jtable
from opencorr_tpu_torch.data import poi as tpoi

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _filled_jax_table(n=24, seed=0):
    """A JAX table with every field holding distinct values."""
    rng = np.random.default_rng(seed)
    t = oc.new_table_2d(rng.uniform(10, 90, n), rng.uniform(10, 70, n))
    return t.replace(
        p=jnp.asarray(rng.normal(size=(n, 12)), jnp.float32),
        r=jnp.asarray(rng.normal(size=(n, 6)), jnp.float32),
        e=jnp.asarray(rng.normal(size=(n, 3)) * 1e-3, jnp.float32),
        sr=jnp.asarray(rng.integers(5, 20, (n, 2)), jnp.float32))


def _to_port(tj):
    return ot.table_from_numpy(*(np.asarray(getattr(tj, f))
                                 for f in ("x", "y", "p", "r", "e", "sr")),
                               device=CPU)


@pytest.mark.parametrize("args", [((30, 30), 100, 300, 2),
                                  ((12.5, 7.0), 7, 5, 3)])
def test_poi_grid_matches_jax(args):
    tj = oc.poi_grid_2d(*args)
    tt = ot.poi_grid_2d(*args, device=CPU)
    assert tt.n == tj.n
    np.testing.assert_array_equal(tt.x.numpy(), np.asarray(tj.x))
    np.testing.assert_array_equal(tt.y.numpy(), np.asarray(tj.y))
    for f in ("p", "r", "e", "sr"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)))
    # x varies fastest (poi.py:209-217)
    assert tt.x[1] - tt.x[0] == args[3] and tt.y[1] == tt.y[0]


def test_field_indices_match_jax():
    assert (tpoi.U, tpoi.UX, tpoi.UY, tpoi.V, tpoi.VX, tpoi.VY) == (
        jpoi.U, jpoi.UX, jpoi.UY, jpoi.V, jpoi.VX, jpoi.VY)
    assert (tpoi.UXX, tpoi.UXY, tpoi.UYY, tpoi.VXX, tpoi.VXY, tpoi.VYY) == (
        jpoi.UXX, jpoi.UXY, jpoi.UYY, jpoi.VXX, jpoi.VXY, jpoi.VYY)
    assert (tpoi.R_U0, tpoi.R_V0, tpoi.R_ZNCC, tpoi.R_ITER, tpoi.R_CONV,
            tpoi.R_FEAT) == (jpoi.R_U0, jpoi.R_V0, jpoi.R_ZNCC, jpoi.R_ITER,
                             jpoi.R_CONV, jpoi.R_FEAT)


def test_table_numpy_round_trip():
    tj = _filled_jax_table()
    tt = _to_port(tj)
    back = ot.table_to_numpy(tt)
    for f in ("x", "y", "p", "r", "e", "sr"):
        assert back[f].dtype == np.float32
        np.testing.assert_array_equal(back[f], np.asarray(getattr(tj, f)))
    np.testing.assert_array_equal(tt.u.numpy(), np.asarray(tj.u))
    np.testing.assert_array_equal(tt.v.numpy(), np.asarray(tj.v))
    np.testing.assert_array_equal(tt.zncc.numpy(), np.asarray(tj.zncc))


def test_table_from_numpy_rejects_bad_shapes():
    n = 4
    z = np.zeros
    with pytest.raises(ValueError, match="field p"):
        ot.table_from_numpy(z(n), z(n), z((n, 6)), z((n, 6)), z((n, 3)),
                            z((n, 2)), device=CPU)


def _read(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines


def _parse(lines, skip=0):
    rows = [[float(v) for v in ln.rstrip(",").split(",")]
            for ln in lines[skip:]]
    return np.asarray(rows, np.float64)


def test_save_table_2d_matches_jax(tmp_path):
    tj = _filled_jax_table()
    tt = _to_port(tj)
    pj, pt = tmp_path / "jax.csv", tmp_path / "torch.csv"
    jtable.save_table_2d(str(pj), tj)
    ot.save_table_2d(str(pt), tt)
    lj, lt = _read(pj), _read(pt)
    assert lt[0] == lj[0]
    assert lt[1].endswith(",")
    np.testing.assert_array_equal(_parse(lt, 1), _parse(lj, 1))
    # and the port reads its own table back
    back = ot.load_table_2d(str(pt), device=CPU)
    for f in ("x", "y", "r", "e", "sr"):
        np.testing.assert_allclose(getattr(back, f).numpy(),
                                   np.asarray(getattr(tj, f)), atol=1e-7)


def test_save_deformation_table_2d_matches_jax(tmp_path):
    tj = _filled_jax_table(seed=1)
    tt = _to_port(tj)
    pj, pt = tmp_path / "jax.csv", tmp_path / "torch.csv"
    jtable.save_deformation_table_2d(str(pj), tj)
    ot.save_deformation_table_2d(str(pt), tt)
    lj, lt = _read(pj), _read(pt)
    assert lt[0] == lj[0]
    np.testing.assert_array_equal(_parse(lt, 1), _parse(lj, 1))


@pytest.mark.parametrize("variable", ["u", "zncc", "exx", "iteration"])
def test_save_map_2d_matches_jax(tmp_path, variable):
    tj = oc.poi_grid_2d((3, 2), 6, 4, 3)
    rng = np.random.default_rng(2)
    tj = tj.replace(
        p=jnp.asarray(rng.normal(size=(tj.n, 12)), jnp.float32),
        r=jnp.asarray(rng.normal(size=(tj.n, 6)), jnp.float32),
        e=jnp.asarray(rng.normal(size=(tj.n, 3)), jnp.float32))
    tt = _to_port(tj)
    pj, pt = tmp_path / "jax.csv", tmp_path / "torch.csv"
    jtable.save_map_2d(str(pj), tj, variable, 16, 20)
    ot.save_map_2d(str(pt), tt, variable, 16, 20)
    lj, lt = _read(pj), _read(pt)
    assert len(lt) == len(lj) == 16
    np.testing.assert_array_equal(_parse(lt), _parse(lj))


def test_image_from_array():
    a = (np.arange(12).reshape(3, 4) * 20).astype(np.uint8)
    img = ot.Image2D.from_array(a)
    assert img.mat.dtype == np.float32 and (img.height, img.width) == (3, 4)
    np.testing.assert_array_equal(img.mat, oc.Image2D.from_array(a).mat)


def test_import_loads_neither_jax_nor_jax_package():
    code = ("import sys, opencorr_tpu_torch\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m == 'opencorr_tpu'"
            " or m.startswith('opencorr_tpu.'))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_port_sources_name_no_jax():
    """No module of the port imports jax or the JAX package: every source
    file, the multi-GPU layer (``parallel/``) and the examples among
    them."""
    root = os.path.join(REPO, "opencorr_tpu_torch")
    seen = set()
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            seen.add(os.path.relpath(os.path.join(dirpath, fn), root))
            with open(os.path.join(dirpath, fn)) as f:
                for ln in f:
                    s = ln.strip()
                    if s.startswith(("import ", "from ")):
                        words = s.replace(",", " ").split()
                        assert "jax" not in words[1].split("."), (fn, s)
                        assert words[1].split(".")[0] != "opencorr_tpu", (fn, s)
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/halo.py",
            "examples/dvc.py", "examples/reconstruction_epipolar.py",
            "utils/speckle_quality.py"} <= seen


def test_top_level_exports_follow_jax():
    """The port exports every name the JAX package's ``__init__`` does,
    and, as there, the multi-GPU classes and helpers only from
    ``parallel``."""
    missing = set(oc.__all__) - set(ot.__all__)
    assert missing == set(), missing
    for name in ("ShardedICGN3D1", "make_mesh", "halo_exchange_z",
                 "partition_pois_z", "assess", "SpeckleQuality"):
        assert not hasattr(oc, name) and not hasattr(ot, name)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.poi_grid_2d((30, 30), 4, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.FFTCC2D(16, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.ICGN2D1(16, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.Strain(20, 5)
    assert ot.resolve_device("cpu") == torch.device("cpu")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_unported_options_raise():
    """Every option of the JAX package's 2D modules is ported: the
    self-adaptive subsets (tests/test_torch_adaptive.py), SIFT2D's opencv
    backend (tests/test_torch_stereo_sift2d.py), FeatureAffine2D's device
    neighbour search (tests/test_torch_fa_device.py) and the refiners'
    global ``eval_mode`` (tests/test_torch_iclm_nr.py) take their
    settings; NR2D1 has no self-adaptive mode and raises, as the
    reference has none."""
    for cls in (ot.ICGN2D1, ot.ICGN2D2, ot.ICLM2D1, ot.ICLM2D2):
        m = cls(16, 16, eval_mode="global", device=CPU)
        m.set_self_adaptive(True)
        assert m.self_adaptive and m.eval_mode == "global"
    with pytest.raises(NotImplementedError):
        ot.NR2D1(16, 16, device=CPU).set_self_adaptive(True)
    assert ot.SIFT2D(backend="opencv", device=CPU).backend == "opencv"
    fa = ot.FeatureAffine2D(16, 16, neighbor_backend="device", device=CPU)
    fa.set_self_adaptive(True)
    assert fa.self_adaptive and fa.neighbor_backend == "device"


def test_sift2d_backend_follows_the_environment(monkeypatch):
    """As in the JAX package, ``backend=None`` reads OPENCORR_SIFT2D."""
    monkeypatch.setenv("OPENCORR_SIFT2D", "opencv")
    assert ot.SIFT2D(device=CPU).backend == oc.SIFT2D().backend == "opencv"
    monkeypatch.delenv("OPENCORR_SIFT2D")
    assert ot.SIFT2D(device=CPU).backend == "device"


@pytest.mark.parametrize("dim", [2, 3])
def test_sort_by_zncc_matches_jax(dim):
    """sortByZNCC: stable, descending ZNCC; the same permutation and
    reordered table (ties keep their order)."""
    from opencorr_tpu.models import base as jbase
    from opencorr_tpu_torch.models import base as tbase

    rng = np.random.default_rng(dim)
    n = 40
    xyz = [rng.uniform(0, 100, n).astype(np.float32) for _ in range(dim)]
    if dim == 2:
        jt, tt = oc.new_table_2d(*xyz), ot.new_table_2d(*xyz, device=CPU)
        width, col = 9, tpoi.R_ZNCC
    else:
        jt, tt = oc.new_table_3d(*xyz), ot.new_table_3d(*xyz, device=CPU)
        width, col = 8, tpoi.R3_ZNCC
    r = rng.uniform(-1, 1, (n, width)).astype(np.float32)
    r[:, col] = np.round(rng.uniform(-1, 1, n), 1)  # ties
    p = rng.standard_normal((n, 12)).astype(np.float32)
    jt = jt.replace(r=r, p=p)
    tt = tt.replace(r=torch.from_numpy(r), p=torch.from_numpy(p))
    jout, jorder = jbase.sort_by_zncc(jt)
    tout, torder = tbase.sort_by_zncc(tt)
    np.testing.assert_array_equal(torder, jorder)
    for f in type(tt).FIELDS:
        np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                      np.asarray(getattr(jout, f)))
    assert (np.diff(tout.zncc.numpy()) <= 0).all()


def test_colorful_image_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    bgr = rng.integers(0, 256, (23, 31, 3)).astype(np.uint8)
    path = str(tmp_path / "colour.png")
    cv2.imwrite(path, bgr)
    j = oc.ColorfulImage2D.load(path)
    t = ot.ColorfulImage2D.load(path)
    for c, plane in zip("bgr", range(3)):
        np.testing.assert_array_equal(getattr(t, c), getattr(j, c))
        np.testing.assert_array_equal(getattr(t, c), bgr[..., plane])
        assert getattr(t, c).dtype == np.float32
    assert (t.height, t.width) == (j.height, j.width) == (23, 31)
    with pytest.raises(IOError):
        ot.ColorfulImage2D.load(str(tmp_path / "missing.png"))
