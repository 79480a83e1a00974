"""2D DIC on one pair: FFTCC2D -> ICGN2D1 -> Strain, chained as
``opencorr_tpu_torch/examples/dic_2d.py::run`` chains its ``fftcc_icgn1``
workload (new modules each pair, ``set_images`` from the host frames, a
synchronise after each stage), followed by the ``strain`` workload's
Strain on the table in memory.  The pair ends when the result table (p,
r, e) is on the host; no table is written to disk.
"""

from __future__ import annotations

import torch

import opencorr_tpu_torch as ot
from opencorr_tpu_torch.ops import _kernels, gather2d, lattice2d

from core.check import Layout
from reference import dic2d as plain

# the kernels the path launches, built at set-up, and the wrappers whose
# launches the roofline readers count, by reader name
KERNELS = ("gather2d", "lattice2d")
COUNTED = {"gather2d": gather2d.gather_windows_2d,
           "lattice2d": lattice2d.lattice_eval_2d}
# u0 v0 zncc iteration of r; u v and ux uy vx vy of p (12-dof rows)
LAYOUT = Layout(seed=(0, 1), zncc=2, iterations=3, disp=(0, 6),
                grad=(1, 2, 7, 8), ref_disp=(0, 3), ref_grad=(1, 2, 4, 5))


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
        self.ref = ot.Image2D.from_array(reference_u8)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def pair(self, target_u8, span) -> dict:
        cfg, dev = self.cfg, self.dev
        tar = ot.Image2D.from_array(target_u8)
        g = cfg["poi_grid"]
        pois = ot.poi_grid_2d(tuple(g["upper_left"]), g["number_x"],
                              g["number_y"], g["step"], device=dev)
        r = cfg["fftcc"]["radius"]
        fftcc = ot.FFTCC2D(r, r, device=dev)
        fftcc.set_images(self.ref, tar)
        with span("fftcc"):
            pois = fftcc.compute(pois)
            self._sync()
        ic = cfg["icgn"]
        icgn = ot.ICGN2D1(ic["radius"], ic["radius"], ic["conv"],
                          ic["max_iter"], device=dev)
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
            strain.prepare(pois)
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
