"""Matmul precision and device selection.

Gauss-Newton stops converging at reduced matmul precision: TF32 keeps about
three decimal digits, which puts a floor on the step norm far above the
0.001 convergence criterion.  Importing this module (the package
``__init__`` does) pins every float32 product and convolution on the card to
full float32, the counterpart of the JAX package's ``highest_precision``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Optional[Union[str, torch.device]]


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in either type),
    so that a constant computed in float64 enters float32 arithmetic as
    the JAX package's float32 constant does."""
    return float(np.float32(x))


def fma(a, b, c):
    """a * b + c rounded once to float32, as a fused multiply-add.  XLA
    contracts the JAX package's float32 multiply-adds on the CPU into such
    single roundings; the product of two float32 values is exact in
    float64, so only the sum rounds (twice, float64 then float32, which
    agrees with one rounding except at exact float32 midpoints).  Any of
    the operands may be a Python float."""
    d = lambda t: t.double() if torch.is_tensor(t) else t
    return (d(a) * d(b) + d(c)).float()


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to bfloat16 (nearest even) and back: the
    operand rounding of the JAX package's bf16 histogram option.  The
    product of two such values is exact in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device a module or function runs on.

    ``None`` means ``cuda``.  A CUDA device that is not present raises: the
    port never carries on quietly on the CPU.  The CPU is used only when the
    caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "opencorr_tpu_torch: no CUDA device is present; pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # the index tensors report, so that devices compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
