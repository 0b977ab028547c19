"""Double-float (two-float) f32 arithmetic: about 48 bits of significand.

Counterpart of chess2rt_tpu/ops/df32.py.  A value is carried as an
unevaluated sum ``hi + lo`` of two float32 tensors (|lo| <= 0.5 ulp(hi)),
enough that a result rounded back to f32 is correctly rounded for every
quantity this module is used on.

Used by the opt-in compensated camera ray-gen
(``SceneStatic.compensated_raygen``, ops/camera.py): the reference computes
its screen corners and per-pixel interpolation in f64 (camera.d:77-174),
and plain f32 corner arithmetic leaves 1-2 ulp errors that the ~1/dir.y
horizon amplification turns into whole-texel UV errors.

The error-free transforms (``two_sum``, and ``two_prod`` by Dekker
splitting, with no fused multiply-add) need every product and sum rounded
on its own.  Eager PyTorch runs each of them as a kernel of its own, so
this module must not be compiled (no ``torch.compile``, no fusion), and it
computes in float32 with TF32 irrelevant (no matmuls).

Representation: a pair ``(hi, lo)`` of equal-shaped f32 tensors.

References: Dekker (1971); Knuth TAOCP v2 section 4.2.2; Hida, Li and
Bailey's double-double algorithms.
"""

from __future__ import annotations

import numpy as np
import torch

_SPLIT = float(np.float32(4097.0))  # 2**12 + 1 for a 24-bit significand


def from_f64(x, device=None):
    """Split a host float64 into an (hi, lo) pair of 0-d f32 tensors."""
    hi = np.float32(x)
    lo = np.float32(np.float64(x) - np.float64(hi))
    return (torch.tensor(hi, dtype=torch.float32, device=device),
            torch.tensor(lo, dtype=torch.float32, device=device))


def to_f32(a):
    """Round a df32 back to a single f32 (hi + lo, correctly rounded)."""
    return a[0] + a[1]


def two_sum(a, b):
    """Error-free a + b -> (s, err) for arbitrary magnitudes (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b| (Dekker)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b -> (p, err) by Dekker splitting (no FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# -- df32 (pair) arithmetic ---------------------------------------------------


def add(a, b):
    """df + df (Knuth add22)."""
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return fast_two_sum(s, e)


def sub(a, b):
    return add(a, (-b[0], -b[1]))


def mul(a, b):
    """df * df (Dekker mul22)."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return fast_two_sum(p, e)


def mul_f32(a, s):
    """df * plain f32 (an exact one-word factor)."""
    p, e = two_prod(a[0], s)
    e = e + a[1] * s
    return fast_two_sum(p, e)


def div(a, b):
    """df / df: an f32 quotient seed and one df-residual correction."""
    q1 = a[0] / b[0]
    r = sub(a, mul_f32(b, q1))
    q2 = (r[0] + r[1]) / b[0]
    return fast_two_sum(q1, q2)


def sqrt(a):
    """df sqrt: an f32 seed and one Heron step with a df residual."""
    s = torch.sqrt(a[0])
    z = torch.zeros_like(s)
    r = sub(a, mul((s, z), (s, z)))
    e = (r[0] + r[1]) / (2.0 * s)
    return fast_two_sum(s, e)


def neg(a):
    return (-a[0], -a[1])


def const(x, like=None, device=None):
    """The df32 constant ``x`` (a host float64): 0-d tensors on ``device``,
    or broadcast to ``like``'s shape on its device."""
    if like is not None:
        hi, lo = from_f64(x, like.device)
        return hi.expand(like.shape), lo.expand(like.shape)
    return from_f64(x, device)


# -- sin / cos ------------------------------------------------------------------

# Taylor coefficients of sin and cos as df32 constants.  On the reduced range
# |y| <= pi/4 the truncation error of these orders is < 4e-18, far below the
# df32 noise floor of ~2^-45.
_SIN_C = [1.0, -1.0 / 6, 1.0 / 120, -1.0 / 5040, 1.0 / 362880, -1.0 / 39916800, 1.0 / 6227020800.0]
_COS_C = [1.0, -0.5, 1.0 / 24, -1.0 / 720, 1.0 / 40320, -1.0 / 3628800, 1.0 / 479001600.0,
          -1.0 / 87178291200.0]

_PI_2 = np.float64(np.pi) / 2


def _poly_even(y2, coeffs):
    """sum_i c_i * (y^2)^i in df32 (Horner)."""
    acc = const(coeffs[-1], like=y2[0])
    for c in reversed(coeffs[:-1]):
        acc = add(mul(acc, y2), const(c, like=y2[0]))
    return acc


def sincos(x):
    """df32 sin and cos of a df32 argument (radians, |x| < ~1e3): a range
    reduction by pi/2 (a df32 constant) and Taylor polynomials on
    |y| <= pi/4 by df32 Horner steps."""
    k = torch.round((x[0] + x[1]) / float(np.float32(_PI_2)))
    y = sub(x, mul_f32(const(_PI_2, like=k), k))
    y2 = mul(y, y)
    s_p = mul(y, _poly_even(y2, _SIN_C))  # sin on the reduced range
    c_p = _poly_even(y2, _COS_C)  # cos on the reduced range
    q = k.to(torch.int32) & 3  # the quadrant

    # sin(x) = [s, c, -s, -c][q], cos(x) = [c, -s, -c, s][q]
    def pick(q0, a, b):
        even = q0 % 2 == 0
        hi = torch.where(even, a[0], b[0])
        lo = torch.where(even, a[1], b[1])
        sign = torch.where(q0 < 2, 1.0, -1.0).to(hi.dtype)
        return hi * sign, lo * sign

    return pick(q, s_p, c_p), pick((q + 1) & 3, s_p, c_p)


def tan(x):
    s, c = sincos(x)
    return div(s, c)
