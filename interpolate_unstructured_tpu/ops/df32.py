"""Double-float (compensated f32) arithmetic for the accurate
interpolation mode.

The float32 fast path tops out near 1e-6 absolute error.  This module
provides the classic
error-free-transform arithmetic (Dekker 1971, Knuth TAOCP 4.2.2) on
*pairs* of f32 arrays — a value is represented as ``hi + lo`` with
``|lo| <= ulp(hi)/2`` — giving ~48 effective mantissa bits (~1e-14
relative) at a handful of native f32 ops per operation.  It is the
numeric core of :mod:`.interp_acc`, which bridges the gap between the
f32 fast path and the f64 reference contract (SURVEY.md §7 "hard
parts": a compensated-f32 middle path).

Only the operations the barycentric / inverse-bilinear weight kernels
need are implemented.  All functions are shape-polymorphic and
jit-safe; inputs are (hi, lo) tuples of equal-shape f32 arrays (lo may
be a scalar 0.0 for exact inputs).

No ``jax.lax`` fused multiply-add is exposed to Python, so products
split each operand in half and combine the four exact partial
products.  The split is a MANTISSA BIT MASK (truncate the low 12 of
the 24 mantissa bits), NOT Dekker's rounding trick (``(2^12+1)*a``):
XLA's CPU backend contracts mul+add chains into FMAs
(``--xla_allow_excess_precision`` semantics), which silently breaks
any algorithm that depends on the ROUNDING of an intermediate product
— jitted Dekker splits measured f32-grade (2.4e-8) while the same
code ran eagerly at 1.9e-14.  With the mask split every partial
product (12 bits x 12 bits = 24 bits) is exactly representable, so an
FMA computes bit-identical values and contraction can never change a
result.  two_sum/quick_two_sum contain no products but are NOT immune:
the simplifier's constant reassociation ``(c + x) - c -> x`` kills
their error term when an operand is a literal, so their sums are
frozen too (see their docstrings).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_MASK = np.uint32(0xFFFFF000)  # keep sign+exp+11 explicit mantissa bits


def two_sum(a, b):
    """Error-free a + b: returns (s, e) with s = fl(a+b), s + e = a + b.

    ``s`` is frozen (see :func:`_freeze`): when either operand is an
    XLA CONSTANT (e.g. the literal 1.0 in ``1 - lam``), the algebraic
    simplifier rewrites ``(c + x) - c -> x`` — float-unsafe
    reassociation it permits for constant operands — which turns the
    error term into exactly 0 and silently degrades df32 to f32
    (measured 3e-8 on the jitted quad weights while eager ran at
    2e-15).  Traced operands never matched the pattern in testing, but
    freezing unconditionally guards composition through ``add``/``mul``
    where sums feed later ``s - a`` shapes."""
    s = _freeze(a + b)
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b| (same constant-reassociation
    guard as :func:`two_sum`: ``e = b - ((a+b) - a)`` collapses to 0 if
    the simplifier folds the parenthesized pattern)."""
    s = _freeze(a + b)
    e = b - (s - a)
    return s, e


def _split(a):
    """Exact 12/12-bit mantissa split: a = hi + lo, both <= 12
    significant bits, via truncation (contraction-proof — see module
    docstring)."""
    bits = jax.lax.bitcast_convert_type(
        jnp.asarray(a, jnp.float32), jnp.uint32
    )
    hi = jax.lax.bitcast_convert_type(bits & _MASK, jnp.float32)
    return hi, a - hi


def _freeze(x):
    """Make ``x`` opaque to FMA contraction.

    XLA:CPU's LLVM backend selects instructions with fp-op fusion
    enabled: a plain ``fmul`` feeding a plain ``fadd``/``fsub`` in the
    same kernel becomes ONE fma — even across `optimization_barrier` /
    double-bitcast, because fusion DUPLICATES the cheap multiply into
    every consumer kernel and instruction selection then sees
    mul-next-to-add again.  ``fl(a*b) + e -> fma(a, b, e)`` silently
    breaks every error-free transform built on the rounding of the
    product (measured: df32 squares degrade from 1e-13 to f32-grade
    1e-6 under jit, while running cleanly op-by-op in eager mode).

    ``where(x == x, x, x + 1)`` is semantically the identity (NaN maps
    to NaN + 1 = NaN) but neither XLA's simplifier nor LLVM can prove
    it, so the select survives to machine code and the product is no
    longer adjacent to its consumer add.  Costs one compare+select."""
    return jnp.where(x == x, x, x + 1.0)


def two_prod(a, b):
    """Error-free a * b: returns (p, e) with p = fl(a*b), p + e = a*b.

    ``p`` is frozen (see :func:`_freeze`): every EFT identity below
    and in the callers depends on ``p`` being the ROUNDED product, not
    an fma re-association of it.  The partial products in ``e`` are
    all exactly representable (12-bit halves), so contraction there is
    value-preserving and they stay unfrozen."""
    p = _freeze(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def add(x, y):
    """df + df -> df (accurate/Knuth variant — the sloppy Dekker add
    loses digits under cancellation of close magnitudes)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    t, f = two_sum(xl, yl)
    s, e = quick_two_sum(s, e + t)
    return quick_two_sum(s, e + f)


def sub(x, y):
    yh, yl = y
    return add(x, (-yh, -yl))


def mul(x, y):
    """df * df -> df."""
    xh, xl = x
    yh, yl = y
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def div(x, y):
    """df / df -> df (one Newton refinement of the f32 quotient)."""
    xh, xl = x
    yh, yl = y
    q1 = xh / yh
    # r = x - q1*y, computed in df
    r = sub(x, mul((q1, jnp.zeros_like(q1)), y))
    q2 = (r[0] + r[1]) / (yh + yl)
    return quick_two_sum(q1, q2)


def sqrt(x):
    """df sqrt (one Newton step from the f32 root)."""
    xh, xl = x
    s1 = jnp.sqrt(xh)
    safe = jnp.where(s1 > 0, s1, 1.0)
    r = sub(x, mul((s1, jnp.zeros_like(s1)), (s1, jnp.zeros_like(s1))))
    s2 = jnp.where(s1 > 0, (r[0] + r[1]) / (2.0 * safe), 0.0)
    return quick_two_sum(s1, s2)


def from_f32(a):
    return a, jnp.zeros_like(a)


def to_f32(x):
    return x[0] + x[1]


def neg(x):
    return -x[0], -x[1]


def scale(x, c):
    """df * exact f32 scalar/array c."""
    return mul(x, (c, jnp.zeros_like(c)))


def dot3(ax, ay, az, bx, by, bz):
    """df dot product of two 3-vectors of df components."""
    return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz))


def cross(ax, ay, az, bx, by, bz):
    """df cross product -> 3 df components."""
    cx = sub(mul(ay, bz), mul(az, by))
    cy = sub(mul(az, bx), mul(ax, bz))
    cz = sub(mul(ax, by), mul(ay, bx))
    return cx, cy, cz


def triple(ax, ay, az, bx, by, bz, cx, cy, cz):
    """df scalar triple product a . (b x c)."""
    vx, vy, vz = cross(bx, by, bz, cx, cy, cz)
    return dot3(ax, ay, az, vx, vy, vz)
