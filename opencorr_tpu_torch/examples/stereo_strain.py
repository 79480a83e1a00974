"""Stereo 3D-DIC strain (the reference's test_3d_dic_strain.cpp): strain of
a stereo result table, fitted against its reconstructed 3D coordinates.

Usage: python -m opencorr_tpu_torch.examples.stereo_strain TABLE_CSV
    [OUT_CSV]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..data import poi as poi_mod
from ..io import table as io_table
from ..models.strain import Strain
from ..utils.precision import DeviceLike, resolve_device


def run(table, out_path=None, device: DeviceLike = None):
    """Strain at r=20 with at least 5 neighbours.  ``table``: a
    POITable2DS or the path of a stereo result CSV.  Returns (table,
    seconds of the strain step, closed by a device synchronisation)."""
    dev = resolve_device(device)
    if not isinstance(table, poi_mod.POITable2DS):
        table = io_table.load_table_2ds(table, device=dev)
    strain = Strain(subregion_radius=20.0, neighbor_number_min=5,
                    device=dev)
    t0 = time.perf_counter()
    table = strain.compute(table)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    if out_path is not None:
        io_table.save_table_2ds(out_path, table)
    return table, seconds


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    pois, sec = run(sys.argv[1], sys.argv[2] if len(sys.argv) > 2
                    else "GT4-0273_0_strain_r20.csv")
    e = pois.e.cpu().numpy()
    print(f"Strain calculation: {sec:.3f}s")
    print("exx stats:", np.percentile(e[:, 0], [5, 50, 95]))
