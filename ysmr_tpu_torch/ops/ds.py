"""Double-single (two-float32) arithmetic: error-free transformations.

Counterpart of ``ysmr_tpu/ops/ds.py``. Every value is an unevaluated sum
``hi + lo`` with ``|lo| <= ulp(hi)/2`` (~48-bit effective mantissa), on
float32 tensors. Used by ``ops/gsff.py`` (the filter bank follows the
reference's float64 trajectories through a self-feedback loop) and
``ops/labeling.py`` (exact min-area comparisons between hull-edge
candidate rectangles).

PyTorch runs each operation on its own and never contracts ``a*b + c``
into an fma, so these are the textbook (fma-free) transformations on both
devices. XLA:CPU does contract inside ``jit``, which only tightens the
error terms: the JAX package's bits can differ in the ``lo`` halves, and
the tests compare with a stated tolerance. ``fma_f32`` is the exception:
a float32 fma computed exactly, for the few places where the port keeps
XLA's contracted bits.
"""

import torch


def two_sum(a, b):
    """Knuth two-sum: a + b = s + e exactly (no magnitude precondition)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Dekker fast two-sum; requires |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Veltkamp/Dekker two-product: a * b = p + e exactly (f32, no FMA).

    Split factor 2**12 + 1 halves the 24-bit f32 mantissa. Safe for the
    coordinate magnitudes in this package (overflow needs |a| ~ 2**115).
    """
    p = a * b
    ca = 4097.0 * a
    ah = ca - (ca - a)
    al = a - ah
    cb = 4097.0 * b
    bh = cb - (cb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def add(xh, xl, yh, yl):
    """Double-single addition (Dekker add2, ~1 ulp**2 error)."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return quick_two_sum(s, e)


def sub(xh, xl, yh, yl):
    return add(xh, xl, -yh, -yl)


def mul(xh, xl, yh, yl):
    """Double-single multiplication."""
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def div_by_f32(xh, xl, d):
    """Double-single divided by an exact float32 divisor, DS quotient."""
    q0 = xh / d
    r0h, r0l = two_prod(q0, d)
    rh, rl = sub(xh, xl, r0h, r0l)
    q1 = (rh + rl) / d
    return quick_two_sum(q0, q1)


def dot_tree(gh, gl, wh, wl):
    """DS dot product over the last axis via pairwise tree reduction (the
    JAX module's order: the odd element folds into slot 0 first, then the
    first half adds the second half).

    :param gh, gl: coefficient pair, broadcastable against the window
    :param wh, wl: window pair (..., W)
    :return: (hi, lo) with the trailing axis reduced
    """
    ph, pl = mul(gh, gl, wh, wl)
    n = ph.shape[-1]
    while n > 1:
        half = n // 2
        if n % 2:  # fold the odd element into slot 0 first
            ph0, pl0 = add(ph[..., :1], pl[..., :1],
                           ph[..., n - 1:n], pl[..., n - 1:n])
            ph = ph[..., :n - 1].clone()
            pl = pl[..., :n - 1].clone()
            ph[..., :1] = ph0
            pl[..., :1] = pl0
        ph, pl = add(ph[..., :half], pl[..., :half],
                     ph[..., half:2 * half], pl[..., half:2 * half])
        n = half
    return ph[..., 0], pl[..., 0]


def fma_f32(a, b, c):
    """float32 ``fmaf(a, b, c)`` (one rounding) on any device, for the
    places where XLA:CPU contracts and the JAX package's bits are kept.

    The product is exact in float64 and the sum is a float64 two-sum; the
    one case where rounding that sum to float32 would round twice (a
    float64 sum exactly halfway between two float32 values) is decided by
    the sign of the two-sum's error term."""
    p = a.to(torch.float64) * b.to(torch.float64)   # exact: 24 x 24 bits
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)   # s + err == p + c exactly
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    toward = torch.where(s > r64, torch.full_like(r, float('inf')),
                         torch.full_like(r, float('-inf')))
    nb = torch.nextafter(r, toward)     # the other f32 neighbour of s
    mid = (r64 + nb.to(torch.float64)) * 0.5   # exact in float64
    use_nb = (s != r64) & (s == mid) & (err != 0) & ((s > r64) == (err > 0))
    return torch.where(use_nb, nb, r)
