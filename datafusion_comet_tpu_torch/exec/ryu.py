"""Float and double to Java's ``Float.toString`` / ``Double.toString``, and
a string's digits back to the nearest double (port of
``datafusion_comet_tpu/exec/ryu.py``, with the parse added).

Spark's ``cast(float|double as string)`` prints the shortest decimal digits
that round-trip (Ryu, Adams PLDI'18), plainly for 1e-3 <= |v| < 1e7 and
as ``d.dddE±x`` otherwise. The port takes a double's bits with
``Tensor.view(torch.int64)`` (the JAX package decomposes the value
arithmetically, its TPU having no f64 bitcast), so subnormals print as Java
prints them. The 64x128-bit multiply-shift against the 5^±q tables runs
on utils/int128.py; the digit-stripping loops are two fixed 18-step masked
loops over the whole column.

``digits_to_double`` is the Eisel-Lemire algorithm (Lemire, "Number
Parsing at a Gigabyte per Second", 2021): a 19-digit mantissa times a
128-bit truncation of 5^q gives the correctly rounded double wherever the
truncation cannot matter, which holds for every decimal exponent q in
[-27, 55]; outside it the rare ambiguous row takes the product's upper
value.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from datafusion_comet_tpu_torch.utils import int128 as I128

__all__ = ["shortest_digits", "format_java", "double_to_string", "float_to_string",
           "digits_to_double"]

_POW5_INV_BITCOUNT = 125
_POW5_BITCOUNT = 125
_M64 = (1 << 64) - 1


def _s64(v: int) -> int:
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def _pow5bits(e: int) -> int:
    return ((e * 1217359) >> 19) + 1


def _build_tables():
    inv = [(1 << (_pow5bits(q) - 1 + _POW5_INV_BITCOUNT)) // 5**q + 1 for q in range(342)]
    pw = []
    for i in range(326):
        p5 = 5**i
        ln = p5.bit_length()
        pw.append(p5 >> (ln - _POW5_BITCOUNT) if ln > _POW5_BITCOUNT
                  else p5 << (_POW5_BITCOUNT - ln))

    def split(vals):
        return (np.array([_s64(v >> 64) for v in vals], np.int64),
                np.array([_s64(v) for v in vals], np.int64))

    return split(inv) + split(pw)


_INV_HI, _INV_LO, _PW_HI, _PW_LO = _build_tables()
_POW5_SMALL = np.array([5**i for i in range(27)], np.int64)  # 5^26 < 2^63

# Eisel-Lemire: 5^q for q in [-342, 308] as 128 bits with the top bit set
# (truncated for q >= 0, rounded up for q < 0)
_EL_MIN_Q, _EL_MAX_Q = -342, 308


def _build_el_table():
    hi, lo = [], []
    for q in range(_EL_MIN_Q, _EL_MAX_Q + 1):
        if q >= 0:
            p = 5**q
            v = p >> (p.bit_length() - 128) if p.bit_length() > 128 else p << (128 - p.bit_length())
        else:
            d = 5**-q
            b = d.bit_length() + 127
            v = (1 << b) // d + 1
            if v.bit_length() > 128:
                v >>= 1
        hi.append(_s64(v >> 64))
        lo.append(_s64(v))
    return np.array(hi, np.int64), np.array(lo, np.int64)


_EL_HI, _EL_LO = _build_el_table()
_TABLES: dict = {}


def _table(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(globals()[name]).to(device)
        _TABLES[key] = t
    return t


def _lshr(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift of a u64 in int64 by a per-row s in [0, 63]."""
    return torch.where(s == 0, x, (x >> s) & ((torch.ones_like(x) << (64 - s)) - 1))


def _mul_shift64(m: torch.Tensor, mul_hi: torch.Tensor, mul_lo: torch.Tensor,
                 j: torch.Tensor) -> torch.Tensor:
    """(m x (mul_hi << 64 | mul_lo)) >> j for 64 < j < 128, m in [0, 2^56)."""
    b0_hi, _ = I128._mul_ulimb(mul_lo, m)
    b2_hi, b2_lo = I128._mul_ulimb(mul_hi, m)
    s_lo, carry = I128._u64_add_carry(b2_lo, b0_hi)
    s_hi = b2_hi + carry
    s = j - 64
    return _lshr(s_lo, s) | torch.where(s == 0, torch.zeros_like(s_hi), s_hi << (64 - s))


def _mult_pow5(val: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return val % _table("_POW5_SMALL", val.device)[p.clamp(0, 26)] == 0


def shortest_digits(mant: torch.Tensor, e2raw: torch.Tensor, mant_is_zero: torch.Tensor,
                    min_exp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ryu: (significand with its hidden bit, binary exponent of its LSB)
    -> (shortest round-tripping digits, decimal exponent), JAX ``ryu.py``
    branch by branch."""
    m2 = mant.long()
    e2 = e2raw.long() - 2
    accept = (m2 & 1) == 0
    mm_shift = torch.where(mant_is_zero & ~min_exp, 0, 1).long()
    mv, mp, mm = 4 * m2, 4 * m2 + 2, 4 * m2 - 1 - mm_shift
    dev = mant.device

    # e2 >= 0
    e2p = e2.clamp(min=0)
    q_a = (e2p * 78913) >> 18
    q_a = (q_a - (e2p > 3).long()).clamp(min=0)
    j_a = -e2p + q_a + _POW5_INV_BITCOUNT + ((q_a * 1217359) >> 19)
    qa_c = q_a.clamp(0, 341)
    ih, il = _table("_INV_HI", dev)[qa_c], _table("_INV_LO", dev)[qa_c]
    vr_a, vp_a, vm_a = (_mul_shift64(v, ih, il, j_a) for v in (mv, mp, mm))
    small_a = q_a <= 21
    mv_div5 = mv % 5 == 0
    vr_tz_a = small_a & mv_div5 & _mult_pow5(mv, q_a)
    vm_tz_a = small_a & ~mv_div5 & accept & _mult_pow5(mm, q_a)
    vp_a = vp_a - (small_a & ~mv_div5 & ~accept & _mult_pow5(mp, q_a)).long()

    # e2 < 0
    ne2 = (-e2).clamp(min=0)
    q_b = (ne2 * 732923) >> 20
    q_b = (q_b - (ne2 > 1).long()).clamp(min=0)
    i_b = ne2 - q_b
    j_b = q_b - (((i_b * 1217359) >> 19) + 1 - _POW5_BITCOUNT)
    ib_c = i_b.clamp(0, 325)
    ph, pl = _table("_PW_HI", dev)[ib_c], _table("_PW_LO", dev)[ib_c]
    vr_b, vp_b, vm_b = (_mul_shift64(v, ph, pl, j_b) for v in (mv, mp, mm))
    q_le1 = q_b <= 1
    low_bits = mv & ((torch.ones_like(mv) << q_b.clamp(max=62)) - 1)
    vr_tz_b = torch.where(q_le1, True, (q_b < 63) & (low_bits == 0))
    vm_tz_b = q_le1 & accept & (mm_shift == 1)
    vp_b = vp_b - (q_le1 & ~accept).long()

    pos = e2 >= 0
    vr = torch.where(pos, vr_a, vr_b)
    vp = torch.where(pos, vp_a, vp_b)
    vm = torch.where(pos, vm_a, vm_b)
    e10 = torch.where(pos, q_a, q_b + e2)
    vr_tz = torch.where(pos, vr_tz_a, vr_tz_b)
    vm_tz = torch.where(pos, vm_tz_a, vm_tz_b)

    removed = torch.zeros_like(vr)
    last = torch.zeros_like(vr)
    for _ in range(18):
        go = (vp // 10) > (vm // 10)
        vm_tz = vm_tz & torch.where(go, vm % 10 == 0, True)
        vr_tz = vr_tz & torch.where(go, last == 0, True)
        last = torch.where(go, vr % 10, last)
        vr, vp, vm = (torch.where(go, v // 10, v) for v in (vr, vp, vm))
        removed = removed + go.long()
    active = vm_tz
    for _ in range(18):
        go = active & (vm % 10 == 0)
        vr_tz = vr_tz & torch.where(go, last == 0, True)
        last = torch.where(go, vr % 10, last)
        vr, vp, vm = (torch.where(go, v // 10, v) for v in (vr, vp, vm))
        removed = removed + go.long()
        active = go
    last = torch.where(vr_tz & (last == 5) & (vr % 2 == 0), 4, last)
    round_up = ((vr == vm) & (~accept | ~vm_tz)) | (last >= 5)
    return vr + round_up.long(), e10 + removed


_SPECIALS = [b"NaN", b"Infinity", b"-Infinity", b"0.0", b"-0.0"]


def format_java(digits: torch.Tensor, e10: torch.Tensor, negative: torch.Tensor,
                is_zero: torch.Tensor, is_nan: torch.Tensor, is_inf: torch.Tensor,
                width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """digits x 10^e10 -> Java's toString bytes (cap, width) and lengths:
    plain for a scientific exponent in [-3, 6], 'd.dddE±x' otherwise, and
    NaN, ±Infinity, ±0.0."""
    MAXD = 17
    dev = digits.device
    d = torch.where(is_zero | is_nan | is_inf, 0, digits)
    planes, x = [], d
    for _ in range(MAXD):
        planes.append(x % 10)
        x = x // 10
    digs = torch.stack(planes, dim=1)  # little-endian
    nonzero = (digs != 0).flip(1).to(torch.uint8)
    nd = torch.where(d == 0, 1, MAXD - nonzero.argmax(1))
    sci = torch.where(is_zero, 0, e10 + nd - 1)
    plain = (sci >= -3) & (sci <= 6)
    pos = torch.arange(width, device=dev)[None, :]
    sgn = negative.long()[:, None]
    ndc = nd[:, None]

    def digit_at(big_idx):
        li = ndc - 1 - big_idx
        ok = (big_idx >= 0) & (li >= 0) & (li < MAXD)
        ch = digs.gather(1, li.clamp(0, MAXD - 1).expand(-1, big_idx.shape[1]))
        return torch.where(ok, ch + ord("0"), ord("0"))

    sc = sci[:, None]
    int_len = torch.where(sc >= 0, sc + 1, 1)
    frac_len = torch.where(sc >= 0, (ndc - (sc + 1)).clamp(min=1), (-sc - 1) + ndc)
    plain_len = sgn + int_len + 1 + frac_len
    p_idx = pos - sgn
    f_idx = p_idx - int_len - 1
    int_ch = torch.where(sc >= 0, digit_at(p_idx.expand(d.shape[0], -1)), ord("0"))
    frac_big = torch.where(sc >= 0, sc + 1 + f_idx, f_idx - (-sc - 1))
    frac_ch = torch.where(frac_big < 0, ord("0"), digit_at(frac_big))
    plain_ch = torch.where(p_idx < int_len, int_ch, torch.where(p_idx == int_len, ord("."),
                                                                frac_ch))
    plain_ch = torch.where((pos == 0) & negative[:, None], ord("-"), plain_ch)
    plain_ch = torch.where(pos < plain_len, plain_ch, 0)

    mant_frac = (ndc - 1).clamp(min=1)
    aexp = sci.abs()[:, None]
    elen = torch.where(aexp >= 100, 3, torch.where(aexp >= 10, 2, 1))
    eneg = sc < 0
    sci_len = sgn + 2 + mant_frac + 1 + eneg.long() + elen
    m_idx = pos - sgn
    zero_idx = torch.zeros_like(p_idx).expand(d.shape[0], -1)
    sci_ch = torch.where(m_idx == 0, digit_at(zero_idx), 0)
    sci_ch = torch.where(m_idx == 1, ord("."), sci_ch)
    fpos = m_idx - 2
    in_frac = (fpos >= 0) & (fpos < mant_frac)
    frac_digit = torch.where(ndc == 1, ord("0"), digit_at((1 + fpos).expand(d.shape[0], -1)))
    sci_ch = torch.where(in_frac, frac_digit, sci_ch)
    e_at = sgn + 2 + mant_frac
    sci_ch = torch.where(pos == e_at, ord("E"), sci_ch)
    sci_ch = torch.where((pos == e_at + 1) & eneg, ord("-"), sci_ch)
    e_idx = pos - (e_at + 1 + eneg.long())
    e_digit = torch.where(e_idx == elen - 1, aexp % 10,
                          torch.where(e_idx == elen - 2, (aexp // 10) % 10, (aexp // 100) % 10))
    sci_ch = torch.where((e_idx >= 0) & (e_idx < elen), e_digit + ord("0"), sci_ch)
    sci_ch = torch.where((pos == 0) & negative[:, None], ord("-"), sci_ch)
    sci_ch = torch.where(pos < sci_len, sci_ch, 0)

    chars = torch.where(plain[:, None], plain_ch, sci_ch)
    lens = torch.where(plain, plain_len[:, 0], sci_len[:, 0])

    spec = np.zeros((len(_SPECIALS), width), np.uint8)
    for i, s in enumerate(_SPECIALS):
        spec[i, : min(len(s), width)] = np.frombuffer(s, np.uint8)[:width]
    slen = torch.tensor([len(s) for s in _SPECIALS], device=dev)
    sel = torch.where(is_nan, 0, torch.where(is_inf, torch.where(negative, 2, 1),
                                             torch.where(negative, 4, 3)))
    any_spec = is_nan | is_inf | is_zero
    chars = torch.where(any_spec[:, None], torch.from_numpy(spec).to(dev)[sel].long(), chars)
    lens = torch.where(any_spec, slen[sel], lens)
    return chars.to(torch.uint8), lens.int()


def double_to_string(x: torch.Tensor, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """float64 -> Java Double.toString bytes and lengths."""
    bits = x.double().view(torch.int64)
    frac = bits & ((1 << 52) - 1)
    exp = (bits >> 52) & 0x7FF
    neg = bits < 0
    is_zero = (exp == 0) & (frac == 0)
    denorm = (exp == 0) & (frac != 0)
    mant = torch.where(denorm, frac, frac | (1 << 52))
    e2 = torch.where(denorm, 1 - 1023 - 52, exp - 1023 - 52)
    digits, e10 = shortest_digits(mant, e2, (frac == 0) & ~denorm, exp <= 1)
    return format_java(digits, e10, neg, is_zero, torch.isnan(x), torch.isinf(x), width)


def float_to_string(x: torch.Tensor, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 -> Java Float.toString bytes and lengths."""
    xf = x.float()
    bits = xf.view(torch.int32).long()
    frac = bits & ((1 << 23) - 1)
    exp = (bits >> 23) & 0xFF
    neg = bits < 0
    is_zero = (exp == 0) & (frac == 0)
    denorm = (exp == 0) & (frac != 0)
    mant = torch.where(denorm, frac, frac | (1 << 23))
    e2 = torch.where(denorm, 1 - 127 - 23, exp - 127 - 23)
    digits, e10 = shortest_digits(mant, e2, (frac == 0) & ~denorm, exp <= 1)
    return format_java(digits, e10, neg, is_zero, torch.isnan(xf), torch.isinf(xf), width)


def _u64_mul(a: torch.Tensor, b: torch.Tensor):
    """Unsigned 64 x 64 -> (hi, lo) of u64s stored in int64."""
    hi, lo = I128.mul_i64(a, b)
    hi = hi + torch.where(a < 0, b, 0) + torch.where(b < 0, a, 0)
    return hi, lo


def _clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of a nonzero u64 in int64 (64 for zero)."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top = _lshr(x, torch.full_like(x, 64 - s)) == 0
        n = torch.where(top, n + s, n)
        x = torch.where(top, x << s, x)
    return torch.where(x == 0, 64, n)


def digits_to_double(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The double nearest w x 10^q (w a u64 of at most 19 decimal digits in
    int64, q an int64 exponent), rounded half to even."""
    dev = w.device
    zero = (w == 0) | (q < _EL_MIN_Q)
    inf = (q > _EL_MAX_Q) & (w != 0)
    qc = q.clamp(_EL_MIN_Q, _EL_MAX_Q)
    lz = _clz64(w)
    wn = w << lz.clamp(max=63)
    t_hi = _table("_EL_HI", dev)[qc - _EL_MIN_Q]
    t_lo = _table("_EL_LO", dev)[qc - _EL_MIN_Q]
    hi, lo = _u64_mul(wn, t_hi)
    ambiguous = (hi & 0x1FF) == 0x1FF
    s_hi, _ = _u64_mul(wn, t_lo)
    lo2 = lo + s_hi
    carry = I128._u64_lt(lo2, lo)
    hi = torch.where(ambiguous & carry, hi + 1, hi)
    lo = torch.where(ambiguous, lo2, lo)
    upperbit = _lshr(hi, torch.full_like(hi, 63))
    mantissa = _lshr(hi, upperbit + 9)
    power2 = (((152170 + 65536) * qc) >> 16) + 63 + upperbit - lz + 1023
    # a tie is only a tie where the product was exact
    tie = ((lo == 0) | (lo == 1)) & (qc >= -4) & (qc <= 23) & ((mantissa & 3) == 1) \
        & ((mantissa << (upperbit + 9)) == hi)
    mantissa = torch.where(tie, mantissa & ~1, mantissa)
    # subnormal: shift the extra bits out first
    sub = power2 <= 0
    shift = (1 - power2).clamp(0, 63)
    m_sub = _lshr(mantissa, shift)
    m_sub = (m_sub + (m_sub & 1)) >> 1
    p_sub = (m_sub >= (1 << 52)).long()
    mantissa = (mantissa + (mantissa & 1)) >> 1
    over = mantissa >= (1 << 53)
    mantissa = torch.where(over, 1 << 52, mantissa)
    power2 = torch.where(over, power2 + 1, power2)
    mantissa = torch.where(sub, torch.where(1 - power2 >= 64, 0, m_sub), mantissa)
    power2 = torch.where(sub, torch.where(1 - power2 >= 64, 0, p_sub), power2)
    inf = inf | (power2 >= 0x7FF)
    bits = (power2 << 52) | (mantissa & ((1 << 52) - 1))
    bits = torch.where(zero, 0, torch.where(inf, 0x7FF0000000000000, bits))
    return bits.view(torch.float64)
