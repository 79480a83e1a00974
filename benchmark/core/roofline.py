"""The benchmark's own count of each hand-written kernel's bytes and
operations, and the chip's peaks.

A kernel's bound is the larger of its bytes over the peak memory
bandwidth and its float32 operations over the peak float32 rate outside
the tensor cores; its roofline share is the bound summed over the traced
launches (counted per launch shape by the program's wrappers) divided by
the device time the trace gives the kernel.  Bytes count each input once
and each output once.  Operations count every sample as in range, which
could only raise a bound that operations set; at every shape the cells
run, the byte bound is more than twice the operation bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, 700 W): HBM3 and float32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# operations per in-range sample: 2D, 8 cubic weights (3 mul + 3 add
# each) and 16 taps (2 mul + 1 add each); 3D, 12 basis values (21 per
# axis), 16 yz products and 64 taps (2 mul + 1 add each)
LATTICE2D_FLOPS = 8 * 6 + 16 * 3
LATTICE3D_FLOPS = 3 * 21 + 16 + 64 * 3


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S)


def gather2d(shape, image_hw) -> float:
    """Kernel 1 at launch shape (n, sh, sw) on an image of ``image_hw``:
    the image, the windows written and two int32 corners a window."""
    n, sh, sw = shape
    h, w = image_hw
    return bound_s((h * w + n * sh * sw + 2 * n) * 4)


def lattice2d(shape) -> float:
    """Kernel 2 at launch shape (n, sy, sx, D): the [n, sy+w-1, sx+w-1]
    blocks (w = 4 + 2D), two int32 offsets and two float32 fractions a
    sample, and the output."""
    n, sy, sx, d = shape
    w = 4 + 2 * d
    nbytes = (n * (sy + w - 1) * (sx + w - 1) + 5 * n * sy * sx) * 4
    return bound_s(nbytes, n * sy * sx * LATTICE2D_FLOPS)


def lattice3d(shape) -> float:
    """Kernel 3 at launch shape (n, sz, sy, sx, D): the blocks, three int32
    offsets and three float32 fractions a sample, and the output."""
    n, sz, sy, sx, d = shape
    w = 4 + 2 * d
    s = sz * sy * sx
    nbytes = (n * (sz + w - 1) * (sy + w - 1) * (sx + w - 1) + 7 * n * s) * 4
    return bound_s(nbytes, n * s * LATTICE3D_FLOPS)


def share(run, counter: str, kernel: str, bound_fn):
    """The roofline share (%) of ``kernel`` over the traced window: the
    bound of every launch the wrapper ``counter`` counted, over the device
    seconds of the operations named ``kernel``; None where either is
    missing."""
    shapes = run.launch_shapes.get(counter)
    if run.trace is None or not shapes:
        return None
    device_s = run.trace.seconds_of(kernel)
    if device_s <= 0:
        return None
    bound = sum(count * bound_fn(shape) for shape, count in shapes.items())
    return 100.0 * bound / device_s
