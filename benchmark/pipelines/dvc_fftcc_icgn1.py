"""DVC on one volume pair: FFTCC3D -> ICGN3D1 -> Strain, chained as
``opencorr_tpu_torch/examples/dvc.py::run`` chains its ``fftcc_icgn1``
workload (new modules each pair, ``set_images`` from the host volumes, a
synchronise after each stage; ICGN3D1 with its default lattice eval and
automatic chunks), followed by the ``strain`` workload's Strain on the
table in memory.  The pair ends when the result table (p, r, e) is on the
host; no table is written to disk.
"""

from __future__ import annotations

import torch

import opencorr_tpu_torch as ot
from opencorr_tpu_torch.ops import _kernels, lattice3d

from core.check import Layout
from reference import dvc as plain

KERNELS = ("lattice3d",)
COUNTED = {"lattice3d": lattice3d.lattice_eval_3d}
# u0 v0 w0 zncc iteration of r; u v w and their gradients of p
LAYOUT = Layout(seed=(0, 1, 2), zncc=3, iterations=4, disp=(0, 4, 8),
                grad=(1, 2, 3, 5, 6, 7, 9, 10, 11), ref_disp=(0, 4, 8),
                ref_grad=(1, 2, 3, 5, 6, 7, 9, 10, 11))


class Pipeline:
    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.dev = ot.resolve_device(device)
        # build seconds by kernel, 0 for a library found built
        self.build_s = {}
        if self.dev.type == "cuda":
            self.build_s = _kernels.build(KERNELS)
            for name in KERNELS:
                _kernels.load(name)
        self.ref = None
        # the last pair's FFTCC and refiner branch counts (their ``stats``)
        self.stats = {}

    def setup(self, reference_u8) -> None:
        self.ref = ot.Image3D.from_array(reference_u8)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def pair(self, target_u8, span) -> dict:
        cfg, dev = self.cfg, self.dev
        tar = ot.Image3D.from_array(target_u8)
        g = cfg["poi_grid"]
        pois = ot.poi_grid_3d(tuple(g["origin"]), g["number_x"],
                              g["number_y"], g["number_z"], g["step"],
                              device=dev)
        r = cfg["fftcc"]["radius"]
        fftcc = ot.FFTCC3D(r, r, r, device=dev)
        fftcc.set_images(self.ref, tar)
        with span("fftcc"):
            pois = fftcc.compute(pois)
            self._sync()
        ic = cfg["icgn"]
        ri = ic["radius"]
        icgn = ot.ICGN3D1(ri, ri, ri, ic["conv"], ic["max_iter"], device=dev)
        with span("icgn.prepare"):
            icgn.set_images(self.ref, tar)
            icgn.prepare()
            self._sync()
        with span("icgn.compute"):
            pois = icgn.compute(pois)
            self._sync()
        self.stats = {**{f"fftcc.{k}": v for k, v in fftcc.stats.items()},
                      **{f"icgn.{k}": v for k, v in icgn.stats.items()}}
        st = cfg["strain"]
        strain = ot.Strain(st["radius"], st["neighbor_min"], device=dev)
        strain.set_zncc_threshold(st["zncc_min"])
        with span("strain"):
            pois = strain.compute(pois)
            self._sync()
        with span("readback"):
            return {"p": pois.p.cpu().numpy(), "r": pois.r.cpu().numpy(),
                    "e": pois.e.cpu().numpy()}

    def close(self) -> None:
        self.ref = None


def reference(cfg: dict, reference_u8, target_u8, device,
              dtype=torch.float64) -> dict:
    return plain.run(reference_u8, target_u8, cfg, device, dtype)
