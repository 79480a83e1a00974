"""Kernel 2 (``csrc/lattice2d.cu``, the bicubic lattice eval) over the
traced window: its bound summed over the counted launches over the device
time of ``lattice2d_kernel`` (%)."""

from core import roofline


def read(run):
    return roofline.share(run, "lattice2d", "lattice2d_kernel",
                          roofline.lattice2d)
