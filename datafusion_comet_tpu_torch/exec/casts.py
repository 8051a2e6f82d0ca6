"""The string rows of the cast matrix (JAX ``evaluator.py:1163-1469``):
integers, decimals, dates and booleans to their Spark text, timestamps to
'yyyy-MM-dd HH:mm:ss[.ffffff]', and a string parsed back to every scalar
type, Spark's trim-then-parse. Floats print through exec/ryu.py.

A string that does not parse is null under LEGACY and TRY and records
CAST_INVALID_INPUT under ANSI, on live rows only (``EvalContext``).

One deliberate difference from the JAX package: a string's digits become a
double by correct rounding (exec/ryu.py ``digits_to_double``) where the JAX
package accumulates them in float64 and can miss the nearest double by an
ulp past 15 significant digits (ROADMAP C27). Which strings parse, and to
what, is otherwise the same.
"""

from __future__ import annotations

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec import decimal_wide as DW
from datafusion_comet_tpu_torch.exec import ryu
from datafusion_comet_tpu_torch.exec.batch import ColumnVector
from datafusion_comet_tpu_torch.exec.temporal import (MU_DAY, civil_from_days,
                                                      days_from_civil, format_timestamp_string)
from datafusion_comet_tpu_torch.ir import expr as E

__all__ = ["cast_to_string", "float_to_string", "timestamp_to_string", "cast_string_to"]

_D0 = ord("0")
_POW10 = [10**i for i in range(19)]


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8)


def cast_to_string(cv: ColumnVector, frm: T.DataType, to: T.DataType) -> ColumnVector:
    """An integer, decimal, date or boolean as its Spark text, in
    ``to.byte_width`` bytes (the length is the text's, as in the JAX
    package, even where the width cuts it)."""
    cap, w = cv.capacity, to.byte_width
    dev = cv.data.device
    if frm.is_boolean:
        tmat = np.zeros((2, w), np.uint8)
        tmat[1, : min(4, w)] = np.frombuffer(b"true", np.uint8)[:w]
        tmat[0, : min(5, w)] = np.frombuffer(b"false", np.uint8)[:w]
        b = cv.data.bool()
        return ColumnVector(torch.from_numpy(tmat).to(dev)[b.long()], cv.validity,
                            torch.where(b, 4, 5).int(), to)
    if frm.type_id == "DATE":
        y, m, d = (v.long() for v in civil_from_days(cv.data))
        dash = torch.full_like(y, ord("-"))
        cols = [y // 1000 % 10 + _D0, y // 100 % 10 + _D0, y // 10 % 10 + _D0, y % 10 + _D0, dash,
                m // 10 % 10 + _D0, m % 10 + _D0, dash, d // 10 % 10 + _D0, d % 10 + _D0]
        chars = torch.zeros((cap, w), dtype=torch.uint8, device=dev)
        n = min(w, 10)
        chars[:, :n] = _u8(torch.stack(cols[:n], dim=1))
        return ColumnVector(chars, cv.validity, torch.full((cap,), 10, dtype=torch.int32,
                                                           device=dev), to)
    scale = frm.scale if frm.is_decimal else 0
    if frm.is_decimal and cv.is_wide_storage:
        digs, negative = DW.digits_39(DW.pair(cv.data))
        u = digs.amax(1)  # only zero or not matters
    else:
        v = cv.data.long()
        negative = v < 0
        x = torch.where(negative, -v, v)
        planes = []
        for _ in range(19):
            planes.append(x % 10)
            x = x // 10
        digs = torch.stack(planes, dim=1)
        u = cv.data.long().abs()
    maxd = digs.shape[1]
    ndig = maxd - (digs != 0).flip(1).to(torch.uint8).argmax(1)
    ndig = torch.where(u == 0, 1, ndig)
    neg = negative.long()
    int_digits = (ndig - scale).clamp(min=1) if scale > 0 else ndig
    total_len = int_digits + (1 + scale if scale > 0 else 0) + neg
    pos = torch.arange(w, device=dev)[None, :]
    sign_off = neg[:, None]
    is_sign = (pos == 0) & negative[:, None]
    if scale > 0:
        dot_pos = sign_off + int_digits[:, None]
        is_dot = pos == dot_pos
        digit_pos = torch.where(pos < dot_pos, pos - sign_off, pos - sign_off - 1)
        n_all = int_digits[:, None] + scale
    else:
        is_dot = torch.zeros_like(is_sign)
        digit_pos = pos - sign_off
        n_all = int_digits[:, None]
    little = (n_all - 1 - digit_pos).clamp(0, maxd - 1)
    dig_chars = digs.long().gather(1, little) + _D0
    valid_digit = (digit_pos >= 0) & (digit_pos < n_all)
    chars = torch.where(is_sign, ord("-"), torch.where(is_dot, ord("."),
                                                       torch.where(valid_digit, dig_chars, 0)))
    chars = torch.where(pos < total_len[:, None], chars, 0)
    return ColumnVector(_u8(chars), cv.validity, total_len.int(), to)


def float_to_string(cv: ColumnVector, frm: T.DataType, to: T.DataType) -> ColumnVector:
    fn = ryu.float_to_string if frm.type_id == "FLOAT" else ryu.double_to_string
    chars, lens = fn(cv.data, to.byte_width)
    return ColumnVector(chars, cv.validity, lens, to)


def timestamp_to_string(micros: torch.Tensor, validity: torch.Tensor,
                        to: T.DataType) -> ColumnVector:
    """Spark's cast(timestamp as string) of a wall clock: 'yyyy-MM-dd
    HH:mm:ss', then '.' and the fraction's digits without trailing zeros."""
    cap = micros.shape[0]
    base = format_timestamp_string(micros, validity)
    frac = ((micros % MU_DAY) + MU_DAY) % 1_000_000
    digs = [(frac // 10 ** (5 - i)) % 10 for i in range(6)]
    ndig = torch.zeros_like(frac)
    seen = torch.zeros_like(frac, dtype=torch.bool)
    for i in range(5, -1, -1):
        seen = seen | (digs[i] != 0)
        ndig = torch.where(seen & (ndig == 0), i + 1, ndig)
    w = max(to.byte_width, 26)
    mat = torch.zeros((cap, w), dtype=torch.uint8, device=micros.device)
    mat[:, :19] = base.data
    has_frac = frac > 0
    mat[:, 19] = _u8(torch.where(has_frac, ord("."), 0))
    for i in range(6):
        mat[:, 20 + i] = _u8(torch.where(has_frac & (i < ndig), digs[i] + _D0, 0))
    lens = torch.where(has_frac, 20 + ndig, 19).int()
    if to.byte_width < w:
        mat, lens = mat[:, : to.byte_width], lens.clamp(max=to.byte_width)
    return ColumnVector(mat, validity, lens, to)


def _trim_bounds(mat: torch.Tensor, lens: torch.Tensor):
    """(first, last, has) of the non-space bytes of each row."""
    w = mat.shape[1]
    pos = torch.arange(w, device=mat.device)[None, :]
    nonspace = (pos < lens[:, None]) & (mat != 32)
    first = nonspace.to(torch.uint8).argmax(1)
    last = w - 1 - nonspace.flip(1).to(torch.uint8).argmax(1)
    return first, last, nonspace.any(1)


def _string_to_timestamp(cv: ColumnVector, to: T.DataType, mode: str, ctx) -> ColumnVector:
    """'yyyy-MM-dd[( |T)HH:mm[:ss[.f{1,6}]]]' (JAX ``evaluator.py:1293``)."""
    mat = cv.data.long()
    cap, w = mat.shape
    first, last, has = _trim_bounds(cv.data, cv.lengths)
    n = last - first + 1

    def ch(i):
        return mat.gather(1, (first + i).clamp(0, w - 1)[:, None])[:, 0]

    def dig(i):
        c = ch(i)
        return c - _D0, (c >= _D0) & (c <= _D0 + 9)

    ok = has & (n >= 10)
    vals, oks = zip(*[dig(i) for i in (0, 1, 2, 3, 5, 6, 8, 9)])
    for o in oks:
        ok = ok & o
    ok = ok & (ch(4) == ord("-")) & (ch(7) == ord("-"))
    y = vals[0] * 1000 + vals[1] * 100 + vals[2] * 10 + vals[3]
    mo, d = vals[4] * 10 + vals[5], vals[6] * 10 + vals[7]
    micros = days_from_civil(y, mo, d) * MU_DAY
    has_time = n >= 16
    (hh_d, hh_ok), (hh2_d, hh2_ok), (mi_d, mi_ok), (mi2_d, mi2_ok) = (dig(i) for i in
                                                                      (11, 12, 14, 15))
    sep_ok = (ch(10) == ord(" ")) | (ch(10) == ord("T"))
    time_ok = sep_ok & hh_ok & hh2_ok & mi_ok & mi2_ok & (ch(13) == ord(":"))
    hh, mi = hh_d * 10 + hh2_d, mi_d * 10 + mi2_d
    has_sec = n >= 19
    (ss_d, ss_ok), (ss2_d, ss2_ok) = dig(17), dig(18)
    sec_ok = ss_ok & ss2_ok & (ch(16) == ord(":"))
    ss = ss_d * 10 + ss2_d
    has_frac = n >= 21
    frac_ok = ch(19) == ord(".")
    frac = torch.zeros(cap, dtype=torch.int64, device=mat.device)
    fdigits = (n - 20).clamp(0, 6)
    for i in range(6):
        fd, fok = dig(20 + i)
        use = i < fdigits
        frac = frac + torch.where(use, fd * 10 ** (5 - i), 0)
        frac_ok = frac_ok & (fok | ~use)
    micros = micros + torch.where(has_time & time_ok, hh * 3_600_000_000 + mi * 60_000_000, 0)
    micros = micros + torch.where(has_sec & sec_ok, ss * 1_000_000, 0)
    micros = micros + torch.where(has_frac & frac_ok, frac, 0)
    ok = ok & (mo >= 1) & (mo <= 12) & (d >= 1) & (d <= 31)
    ok = ok & torch.where(has_time, time_ok & (hh < 24) & (mi < 60), n == 10)
    ok = ok & torch.where(has_sec, sec_ok & (ss < 60), ~has_sec | ~has_time)
    ok = ok & torch.where(has_frac, frac_ok, True)
    if mode == E.EvalMode.ANSI:
        ctx.record_error(~ok & cv.validity, "CAST_INVALID_INPUT")
    return ColumnVector(micros, cv.validity & ok, None, to)


def cast_string_to(cv: ColumnVector, to: T.DataType, mode: str, ctx, tz=None) -> ColumnVector:
    """A padded string column parsed as ``to`` (JAX ``evaluator.py:1362``):
    surrounding spaces trimmed; an integer or decimal is an optional sign
    and digits with at most one '.' (a decimal's extra fraction digits
    round half up), a float digits and dots, a date 'yyyy-mm-dd', a
    boolean t/f/1/0 by its first byte."""
    from datafusion_comet_tpu_torch.exec.evaluator import _int_narrow
    from datafusion_comet_tpu_torch.exec.temporal import tz_offset_micros

    if to.type_id in ("TIMESTAMP", "TIMESTAMP_NTZ"):
        out = _string_to_timestamp(cv, to, mode, ctx)
        if tz and to.type_id == "TIMESTAMP":  # the wall clock in the session zone
            m = out.data
            out = ColumnVector(m - tz_offset_micros(m, tz, local=True), out.validity, None, to)
        return out
    mat = cv.data.long()
    cap, w = mat.shape
    dev = mat.device
    pos = torch.arange(w, device=dev)[None, :]
    first, last, has = _trim_bounds(cv.data, cv.lengths)
    if to.type_id == "DATE":
        def dig(i):
            return mat.gather(1, (first + i).clamp(max=w - 1)[:, None])[:, 0] - _D0

        y = dig(0) * 1000 + dig(1) * 100 + dig(2) * 10 + dig(3)
        ok = has & (last - first == 9)
        days = days_from_civil(y, dig(5) * 10 + dig(6), dig(8) * 10 + dig(9))
        if mode == E.EvalMode.ANSI:
            ctx.record_error(~ok & cv.validity, "CAST_INVALID_INPUT")
        return ColumnVector(days.int(), cv.validity & ok, None, to)
    if to.is_boolean:
        l0 = mat.gather(1, first[:, None])[:, 0]
        one = last - first + 1 == 1
        is_true = ((l0 | 32) == ord("t")) | (one & (l0 == ord("1")))
        is_false = ((l0 | 32) == ord("f")) | (one & (l0 == ord("0")))
        return ColumnVector(is_true, cv.validity & has & (is_true | is_false), None, to)
    if not (to.is_integer or to.is_decimal or to.is_floating):
        raise NotImplementedError(f"cast string -> {to!r}")
    signc = mat.gather(1, first[:, None])[:, 0]
    neg = signc == ord("-")
    start = first + (neg | (signc == ord("+"))).long()
    active = (pos >= start[:, None]) & (pos <= last[:, None])
    ch = torch.where(active, mat, _D0)
    is_dig = (ch >= _D0) & (ch <= _D0 + 9)
    is_dot = ch == ord(".")
    ok_chars = torch.where(active, is_dig | is_dot, True).all(1)
    dots = active & is_dot
    dot_count = dots.sum(1)
    dot_pos = torch.where(dot_count > 0, dots.to(torch.uint8).argmax(1), last + 1)
    frac_digits = torch.where(dot_count > 0, last - dot_pos, 0)
    if to.is_floating:
        # the first 19 significant digits (from the first nonzero one), and
        # how many were dropped past them
        dig_mask = active & is_dig
        m = torch.zeros(cap, dtype=torch.int64, device=dev)
        started = torch.zeros(cap, dtype=torch.bool, device=dev)
        count = torch.zeros(cap, dtype=torch.int64, device=dev)
        for i in range(w):
            started = started | (dig_mask[:, i] & (ch[:, i] != _D0))
            sig = dig_mask[:, i] & started
            count = count + sig.long()
            m = torch.where(sig & (count <= 19), m * 10 + (ch[:, i] - _D0), m)
        dropped = (count - 19).clamp(min=0)
        value = ryu.digits_to_double(m, dropped - frac_digits)
        value = torch.where(neg, -value, value)
        return ColumnVector(value.to(torch.float32 if to.type_id == "FLOAT" else torch.float64),
                            cv.validity & has & ok_chars, None, to)
    val = torch.zeros(cap, dtype=torch.int64, device=dev)
    for i in range(w):
        c = ch[:, i]
        val = torch.where(active[:, i] & (c >= _D0) & (c <= _D0 + 9), val * 10 + (c - _D0), val)
    k = (to.scale if to.is_decimal else 0) - frac_digits
    p10 = torch.tensor(_POW10, dtype=torch.int64, device=dev)
    factor, shrink = p10[k.clamp(0, 18)], p10[(-k).clamp(0, 18)]
    scaled = torch.where(k >= 0, val * factor, (val + shrink // 2) // shrink)
    val_final = torch.where(neg, -scaled, scaled)
    ok = has & ok_chars & (dot_count <= 1)
    if to.is_integer:
        ok = ok & (dot_count == 0)
    if mode == E.EvalMode.ANSI:
        ctx.record_error(~ok & cv.validity, "CAST_INVALID_INPUT")
    if to.is_integer:
        out = _int_narrow(val_final, cv.validity & ok, to, mode, ctx)
        return ColumnVector(out.data, cv.validity & ok, None, to)
    return ColumnVector(val_final, cv.validity & ok, None, to)
