"""Float32 arithmetic in the reference's rounding.

The reference's compiler (XLA) contracts every product that feeds a single
add or subtract into one fused multiply-add, sums a dot product or a
3-element reduction as ``fma(a2, b2, fma(a1, b1, a0 * b0))``, and divides
by a constant as a multiplication by its float32 reciprocal; its square
root is correctly rounded. A path tracer is chaotic: one rounding apart at
a grazing hit sends a path elsewhere. So the plain versions round where the
reference rounds, and the CUDA kernel writes the same FMAs out (``fmaf``,
built with ``--fmad=false`` so the compiler adds none of its own).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# 1 / pi as the reference multiplies by it: the float32 reciprocal of
# float32(pi).
INV_PI = float(np.float32(1.0) / np.float32(math.pi))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add does.

    The product of two float32 values is exact in float64, so the sum
    rounds once to float64 and then to float32; that differs from one FMA
    only when the float64 sum lands exactly halfway between two float32
    values.
    """
    b64 = torch.as_tensor(b, dtype=torch.float32, device=a.device).double()
    c64 = torch.as_tensor(c, dtype=torch.float32, device=a.device).double()
    return (a.double() * b64 + c64).float()


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` over the last axis: fma(a2, b2, fma(a1, b1, a0 * b0))."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def sqrt(a: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as the reference's and
    the kernels' ``sqrtf``: taken in float64 and rounded once to float32
    (exact, since float64 carries more than twice float32's precision).
    PyTorch's own float32 ``sqrt`` gives other bits on the CPU than on the
    card for about 1% of values."""
    return torch.sqrt(a.double()).float()
