"""Per-POI box windows cut from a volume.

The JAX package cuts DVC windows with ``vmap(lax.dynamic_slice)``
(``ops/fftcc.py:306-308``, ``ops/icgn.py:784-792``), outside any Pallas
kernel; here it is one advanced-indexing gather.
"""

from __future__ import annotations

import torch


def gather_windows_3d(vol: torch.Tensor, z0: torch.Tensor, y0: torch.Tensor,
                      x0: torch.Tensor, sz: int, sy: int, sx: int
                      ) -> torch.Tensor:
    """``out[n] = vol[z0[n]:z0[n]+sz, y0[n]:y0[n]+sy, x0[n]:x0[n]+sx]``, the
    corners already clipped into the volume by the caller.  Returns
    [N, sz, sy, sx]."""
    dev = vol.device
    zi = z0.long()[:, None] + torch.arange(sz, device=dev)
    yi = y0.long()[:, None] + torch.arange(sy, device=dev)
    xi = x0.long()[:, None] + torch.arange(sx, device=dev)
    return vol[zi[:, :, None, None], yi[:, None, :, None],
               xi[:, None, None, :]]
