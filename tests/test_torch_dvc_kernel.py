"""The plain PyTorch version of the port's 3D lattice kernel against the
JAX package's Pallas kernel (``pallas_lattice.lattice_eval``) in interpret
mode on the CPU (the CUDA kernel against its plain version is in
test_torch_cuda.py).

Within 1e-6 x max|eblk| (the float32 tap sum may be taken in another
order), and exactly 0 where any placement offset is out of range."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencorr_tpu.ops.pallas_lattice import lattice_eval as j_lattice
from opencorr_tpu_torch.ops import bspline as tbs
from opencorr_tpu_torch.ops import lattice3d
from test_torch_cuda import _lattice3d_inputs, _out_of_range_3d

# One intra-op thread: the suite runs in several worker processes at once,
# and torch's CPU thread pools stall when they oversubscribe the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("d,n,s", [(1, 3, 9), (1, 2, 13), (2, 2, 7)])
def test_lattice3d_plain_vs_jax(d, n, s):
    arrs = _lattice3d_inputs(n, s, d, seed=10 * d + s)
    want = np.asarray(j_lattice(*map(jnp.asarray, arrs), d_wobble=d,
                                interpret=True))
    before = lattice3d.lattice_eval_3d.launches
    got = lattice3d.lattice_eval_3d(*map(torch.from_numpy, arrs),
                                    d_wobble=d).numpy()
    # the wrapper takes the plain version for CPU tensors, uncounted
    assert lattice3d.lattice_eval_3d.launches == before
    bad = _out_of_range_3d(*arrs[1:4], d)
    assert bad.any() and (~bad).any()
    assert (got[bad] == 0.0).all() and (want[bad] == 0.0).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(arrs[0]).max())


def test_lattice3d_plain_is_the_tricubic_eval():
    """Offsets and fractions taken from real sample coordinates: the
    lattice sum over a block cut from a coefficient volume equals the
    global tricubic eval of the same samples."""
    rng = np.random.default_rng(4)
    coeff = rng.uniform(0, 255, (30, 31, 32)).astype(np.float32)
    n, s, d = 3, 7, 1
    e = s + 3 + 2 * d
    base = np.array([[3, 4, 5], [10, 2, 9], [6, 12, 15]])  # z, y, x corners
    k = np.arange(s)
    # per axis: a 0.3 translation and a 15% stretch, so that the floors
    # cross and the offsets take both 0 and 1
    loc = base[:, :, None] + 1 + d + k + 0.3 + 0.15 * (k - 3)  # [n, 3, s]
    gz, gy, gx = np.meshgrid(k, k, k, indexing="ij")
    coords = [loc[:, a][:, g].astype(np.float32)
              for a, g in enumerate((gz, gy, gx))]  # z, y, x: [n, s, s, s]
    want, oob = tbs.tricubic_eval(*(torch.from_numpy(c) for c in
                                    (coeff, coords[2], coords[1],
                                     coords[0])))
    assert not oob.any()
    idx = [np.floor(c).astype(np.int64) for c in coords]
    frac = [torch.from_numpy(c - i.astype(np.float32))
            for c, i in zip(coords, idx)]
    offs = [torch.from_numpy((i - 1 - base[:, a, None, None, None] - g
                              ).astype(np.int32))
            for a, (i, g) in enumerate(zip(idx, (gz, gy, gx)))]
    assert all(set(np.unique(o.numpy())) == {0, 1} for o in offs)
    eblk = torch.from_numpy(np.stack(
        [coeff[b[0]:b[0] + e, b[1]:b[1] + e, b[2]:b[2] + e] for b in base]))
    got = lattice3d.lattice_eval_3d(eblk, *offs, *frac, d_wobble=d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * np.abs(coeff).max())


def test_lattice3d_wrapper_checks_shapes():
    arrs = [torch.from_numpy(a) for a in _lattice3d_inputs(2, 5, 1, seed=0)]
    with pytest.raises(ValueError):
        lattice3d.lattice_eval_3d(*arrs, d_wobble=2)
    short = list(arrs)
    short[3] = short[3][:, :4]
    with pytest.raises(ValueError):
        lattice3d.lattice_eval_3d(*short, d_wobble=1)
    with pytest.raises(ValueError):
        lattice3d.lattice_eval_3d(arrs[0], *(a[0] for a in arrs[1:]),
                                  d_wobble=1)
