"""Elementwise 128-bit integers as (hi, lo) pairs of int64 tensors (port of
``datafusion_comet_tpu/utils/int128.py``, the functions decimal arithmetic
and aggregation reach).

``lo`` holds the low 64 bits read as unsigned: value = hi * 2^64 + (lo as
u64), two's complement. Everything stays int64 with Python-int constants
(torch's uint64 support is thin on CUDA): unsigned order is signed order
with the sign bit flipped, and int64 add/mul/shift wrap mod 2^64 in torch
on both the CPU and CUDA, which the carry tricks rely on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]

_MASK32 = (1 << 32) - 1
_SIGN = -(1 << 63)  # the u64 sign bit as an int64 constant
POW10_I64 = tuple(10**i for i in range(19))


def from_i64(x: torch.Tensor) -> Pair:
    """Sign-extend an int64 to i128."""
    x = x.long()
    return (x >> 63, x)


def _u64_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned less-than for u64 stored in int64."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _u64_add_carry(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Unsigned add of two u64 returning (sum mod 2^64, carry 0/1)."""
    s = a + b
    return s, _u64_lt(s, a).long()


def add(a: Pair, b: Pair) -> Pair:
    lo, carry = _u64_add_carry(a[1], b[1])
    return (a[0] + b[0] + carry, lo)


def neg(a: Pair) -> Pair:
    lo, carry = _u64_add_carry(~a[1], torch.ones_like(a[1]))
    return (~a[0] + carry, lo)


def sub(a: Pair, b: Pair) -> Pair:
    return add(a, neg(b))


def is_negative(a: Pair) -> torch.Tensor:
    return a[0] < 0


def select(m: torch.Tensor, a: Pair, b: Pair) -> Pair:
    """Elementwise ``a if m else b``."""
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]))


def abs_(a: Pair) -> Pair:
    return select(is_negative(a), neg(a), a)


def _lshr32(x: torch.Tensor) -> torch.Tensor:
    """Logical right shift by 32 of a u64 stored in int64."""
    return (x >> 32) & _MASK32


def mul_i64(x: torch.Tensor, y: torch.Tensor) -> Pair:
    """Exact signed 64x64 -> 128 multiply via 32-bit limbs."""
    x, y = x.long(), y.long()
    sx, sy = x < 0, y < 0
    ux = torch.where(sx, -x, x)  # |min| wraps; that value never appears in decimals
    uy = torch.where(sy, -y, y)
    x0, x1 = ux & _MASK32, _lshr32(ux)
    y0, y1 = uy & _MASK32, _lshr32(uy)
    p00, p01, p10, p11 = x0 * y0, x0 * y1, x1 * y0, x1 * y1  # each a u64
    mid = _lshr32(p00) + (p01 & _MASK32) + (p10 & _MASK32)
    lo = (p00 & _MASK32) | ((mid & _MASK32) << 32)
    hi = p11 + (p01 >> 32) + (p10 >> 32) + (mid >> 32)
    res = (hi, lo)
    return select(sx ^ sy, neg(res), res)


def shl1(a: Pair) -> Pair:
    return ((a[0] << 1) | ((a[1] >> 63) & 1), a[1] << 1)


def cmp_ge_u(a: Pair, b: Pair) -> torch.Tensor:
    """Unsigned 128-bit a >= b."""
    return _u64_lt(b[0], a[0]) | ((a[0] == b[0]) & ~_u64_lt(a[1], b[1]))


def cmp(a: Pair, b: Pair) -> torch.Tensor:
    """Signed compare: -1, 0 or 1 (int64)."""
    d = sub(a, b)
    zero = (d[0] == 0) & (d[1] == 0)
    return torch.where(zero, 0, torch.where(is_negative(d), -1, 1))


def _divmod_small(num_hi: torch.Tensor, num_lo: torch.Tensor, den: torch.Tensor):
    """Unsigned 128 / den for 0 < den < 2^31: long division over four 32-bit
    digits. Each partial remainder is < den, so (rem << 32 | digit) < 2^63
    and int64 floor division is exact."""
    rem = torch.zeros_like(num_lo)
    q = []
    for digit in (_lshr32(num_hi), num_hi & _MASK32, _lshr32(num_lo), num_lo & _MASK32):
        acc = (rem << 32) | digit
        qd = acc // den
        rem = acc - qd * den
        q.append(qd)
    return ((q[0] << 32) | q[1], (q[2] << 32) | q[3]), rem


def divmod_u128_u64(num_hi: torch.Tensor, num_lo: torch.Tensor, den: torch.Tensor,
                    den_bound: Optional[int] = None):
    """Unsigned 128/64 -> (quotient i128, remainder u64), den < 2^63.

    The reference form is restoring division, 128 shift/compare/subtract
    steps. ``den_bound`` is a host-known bound on den; below 2^31 the
    four-digit long division gives the same bits in 4 steps, which matters
    on the card where every step is a handful of kernel launches."""
    if den_bound is not None and den_bound < (1 << 31):
        return _divmod_small(num_hi, num_lo, den)
    q_hi = q_lo = r = torch.zeros_like(num_lo)
    n_hi, n_lo = num_hi, num_lo
    for _ in range(128):
        r2 = (r << 1) | ((n_hi >> 63) & 1)
        n_hi = (n_hi << 1) | ((n_lo >> 63) & 1)
        n_lo = n_lo << 1
        ge = ~_u64_lt(r2, den)  # r2 < 2^64 since den < 2^63
        r = torch.where(ge, r2 - den, r2)
        q_hi = (q_hi << 1) | ((q_lo >> 63) & 1)
        q_lo = (q_lo << 1) | ge.long()
    return (q_hi, q_lo), r


def divmod_u128_u128(num: Pair, den: Pair):
    """Unsigned 128/128 -> (quotient, remainder) by restoring division."""
    zero = torch.zeros_like(num[1])
    q, r, n = (zero, zero), (zero, zero), num
    for _ in range(128):
        r2 = ((r[0] << 1) | ((r[1] >> 63) & 1), (r[1] << 1) | ((n[0] >> 63) & 1))
        n = shl1(n)
        ge = cmp_ge_u(r2, den)
        r = select(ge, sub(r2, den), r2)
        q = ((q[0] << 1) | ((q[1] >> 63) & 1), (q[1] << 1) | ge.long())
    return q, r


def div_i128_i128_half_up(a: Pair, b: Pair) -> Pair:
    """Signed i128 / i128 with HALF_UP rounding -> i128."""
    sign_neg = is_negative(a) ^ is_negative(b)
    ua, ub = abs_(a), abs_(b)
    q, r = divmod_u128_u128(ua, ub)
    round_up = cmp_ge_u(shl1(r), ub)
    q = add(q, (torch.zeros_like(q[0]), round_up.long()))
    return select(sign_neg, neg(q), q)


def div_i128_i64_half_up(a: Pair, den: torch.Tensor) -> torch.Tensor:
    """Signed i128 / i64 with HALF_UP rounding, truncated to i64 (den < 2^62)."""
    sign_neg = is_negative(a) ^ (den < 0)
    ua = abs_(a)
    uden = torch.where(den < 0, -den, den)
    (_, q_lo), r = divmod_u128_u64(ua[0], ua[1], uden)
    q_lo = q_lo + (~_u64_lt(r * 2, uden)).long()
    return torch.where(sign_neg, -q_lo, q_lo)


def to_i64(a: Pair) -> torch.Tensor:
    """Truncate i128 to i64 (caller must know it fits)."""
    return a[1]


def to_f64(a: Pair) -> torch.Tensor:
    """Approximate i128 -> float64."""
    ua = abs_(a)
    lo_u = ua[1].double() + torch.where(ua[1] < 0, 2.0**64, 0.0)
    mag = ua[0].double() * 2.0**64 + lo_u
    return torch.where(is_negative(a), -mag, mag)


def _mul_ulimb(limb: torch.Tensor, y: torch.Tensor) -> Pair:
    """Unsigned 64-bit limb x nonnegative i64 -> u128. mul_i64 reads a
    top-bit-set limb as negative; its true value is 2^64 larger, so add y to
    the high limb there."""
    p = mul_i64(limb, y)
    return (p[0] + torch.where(limb < 0, y, torch.zeros_like(y)), p[1])


def mul_i128_i64(a: Pair, y: torch.Tensor) -> Pair:
    """Signed i128 x i64 -> i128 (exact while the product fits)."""
    y = y.long()
    sign_neg = is_negative(a) ^ (y < 0)
    ua = abs_(a)
    uy = torch.where(y < 0, -y, y)
    lo_prod = _mul_ulimb(ua[1], uy)
    res = (lo_prod[0] + ua[0] * uy, lo_prod[1])
    return select(sign_neg, neg(res), res)


def mul_i64_i128_by_small(a: Pair, m: int) -> Pair:
    """i128 x host constant 0 < m < 2^62, exact while the result fits."""
    sign_neg = is_negative(a)
    ua = abs_(a)
    lo_prod = _mul_ulimb(ua[1], torch.full_like(ua[1], m))
    res = (lo_prod[0] + ua[0] * m, lo_prod[1])
    return select(sign_neg, neg(res), res)


def mul_pow10_i64(x: torch.Tensor, k: int) -> Pair:
    """x * 10^k as i128 (k <= 38)."""
    return mul_pow10_i128(from_i64(x), k)


def mul_pow10_i128(a: Pair, k: int) -> Pair:
    """i128 x 10^k (k <= 38), exact while the result fits."""
    while k > 0:
        step = min(k, 18)
        a = mul_i64_i128_by_small(a, POW10_I64[step])
        k -= step
    return a


def shl_bits(a: Pair, k: int) -> Pair:
    """Logical left shift by a constant 0 <= k < 128 (mod 2^128)."""
    if k == 0:
        return a
    if k >= 64:
        return (a[1] << (k - 64) if k > 64 else a[1], torch.zeros_like(a[1]))
    return ((a[0] << k) | ((a[1] >> (64 - k)) & ((1 << k) - 1)), a[1] << k)


def const_u128(v: int, like: torch.Tensor) -> Pair:
    """A nonnegative host constant < 2^128 broadcast to ``like``'s shape."""
    hi, lo = (v >> 64) & ((1 << 64) - 1), v & ((1 << 64) - 1)
    return (torch.full_like(like, hi - (1 << 64) if hi >= (1 << 63) else hi),
            torch.full_like(like, lo - (1 << 64) if lo >= (1 << 63) else lo))


def div_pow10_i128_half_up(a: Pair, k: int) -> Pair:
    """i128 / 10^k with HALF_UP rounding -> i128 (decimal downscale)."""
    sign_neg = is_negative(a)
    ua = abs_(a)
    if k <= 18:
        den = torch.full_like(ua[1], POW10_I64[k])
        q, r = divmod_u128_u64(ua[0], ua[1], den, den_bound=POW10_I64[k])
        round_up = ~_u64_lt(r * 2, den)
    else:  # 10^k needs two limbs
        den2 = const_u128(10**k, ua[1])
        q, r2 = divmod_u128_u128(ua, den2)
        round_up = cmp_ge_u(shl1(r2), den2)
    q = add(q, (torch.zeros_like(q[0]), round_up.long()))
    return select(sign_neg, neg(q), q)


def div_pow10_i128_trunc(a: Pair, k: int) -> Pair:
    """i128 / 10^k truncated toward zero (the decimal to integer cast)."""
    sign_neg = is_negative(a)
    ua = abs_(a)
    if k <= 18:
        den = torch.full_like(ua[1], POW10_I64[k])
        q, _ = divmod_u128_u64(ua[0], ua[1], den, den_bound=POW10_I64[k])
    else:
        q, _ = divmod_u128_u128(ua, const_u128(10**k, ua[1]))
    return select(sign_neg, neg(q), q)


def _u128_digits32(p: Pair) -> list:
    """Nonnegative u128 -> four 32-bit digits, little-endian, in int64s."""
    hi, lo = p
    return [lo & _MASK32, _lshr32(lo), hi & _MASK32, _lshr32(hi)]


def mul_i128_i128_scaled(a: Pair, b: Pair, k: int):
    """Exact (a x b) / 10^k with HALF_UP rounding through a u256
    intermediate. Returns (i128 pair, overflow mask); overflowed rows
    (quotient >= 2^127) are saturated to 10^38 so the caller's precision
    check nulls them.

    32-bit-digit school multiplication (each step < 2^64, so int64 wrap is
    bit-exact), then long division by <= 10^9 chunks (remainder < 2^31
    keeps every (rem << 32 | digit) below 2^63)."""
    sign_neg = is_negative(a) ^ is_negative(b)
    al = _u128_digits32(abs_(a))
    bl = _u128_digits32(abs_(b))
    zero = torch.zeros_like(al[0])
    r = [zero] * 8
    for i in range(4):
        carry = zero
        for j in range(4):
            cur = r[i + j] + al[i] * bl[j] + carry
            r[i + j] = cur & _MASK32
            carry = _lshr32(cur)
        r[i + 4] = carry
    rem_total = (zero, zero)
    shift = 0
    kk = k
    while kk > 0:
        step = min(kk, 9)
        d = 10**step
        rem = zero
        for idx in range(7, -1, -1):
            acc = (rem << 32) | r[idx]
            q = acc // d
            rem = acc - q * d
            r[idx] = q
        rem_total = add(rem_total, mul_pow10_i128(from_i64(rem), shift))
        shift += step
        kk -= step
    over = (r[4] | r[5] | r[6] | r[7]) != 0
    q128 = ((r[3] << 32) | r[2], (r[1] << 32) | r[0])
    over = over | (q128[0] < 0)
    if k > 0:
        half = cmp_ge_u(shl1(rem_total), const_u128(10**k, zero))
        q128 = add(q128, (zero, half.long()))
    q128 = select(over, const_u128(10**38, zero), q128)
    return select(sign_neg, neg(q128), q128), over
