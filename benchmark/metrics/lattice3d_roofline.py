"""Kernel 3 (``csrc/lattice3d.cu``, the tricubic lattice eval) over the
traced window: its bound summed over the counted launches over the device
time of ``lattice3d_kernel`` (%)."""

from core import roofline


def read(run):
    return roofline.share(run, "lattice3d", "lattice3d_kernel",
                          roofline.lattice3d)
