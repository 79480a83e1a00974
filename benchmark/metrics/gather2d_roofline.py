"""Kernel 1 (``csrc/gather2d.cu``, the window gather) over the traced
window: its bound summed over the launches the wrapper counted, by launch
shape, over the device time the trace gives ``gather_windows_kernel`` (%).
"""

from core import roofline


def read(run):
    hw = run.config.get("frame_shape")
    return roofline.share(
        run, "gather2d", "gather_windows_kernel",
        lambda shape: roofline.gather2d(shape, hw))
