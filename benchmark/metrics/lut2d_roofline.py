"""Kernel 6 (``csrc/bicubic2d.cu``, the bicubic eval through the global
per-pixel LUT) over the traced window: its bound summed over the launches
the wrapper counted (by sample count n) over the device time of
``bicubic_eval_kernel`` (%).  A launch moves 13 bytes a sample (two
float32 coordinates in, a float32 value and a mask byte out) and makes 36
float32 operations (19 products, 17 sums); the LUT's 64-byte entries are
left out (read once a pixel under the subsets, they are about 5% of the
bound at the self-adaptive chunk), so the share is a floor."""

from core import roofline

BYTES_PER_SAMPLE = 13
FLOPS_PER_SAMPLE = 19 + 17


def bound(shape) -> float:
    (n,) = shape
    return roofline.bound_s(BYTES_PER_SAMPLE * n, FLOPS_PER_SAMPLE * n)


def read(run):
    return roofline.share(run, "bicubic2d", "bicubic_eval_kernel", bound)
