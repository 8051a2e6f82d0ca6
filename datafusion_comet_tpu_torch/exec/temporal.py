"""Dates and timestamps: every ``TemporalFunc`` (JAX ``evaluator.py:2089-2422``).

A DATE is int32 days since 1970-01-01, a TIMESTAMP or TIMESTAMP_NTZ int64
microseconds since it. A session zone (``TemporalFunc.tz``) shifts a
timestamp to its wall clock before a field is read; the offset of each
instant comes from the zone's transition table (utils/tz.py) by one
``torch.searchsorted`` over the column and a gather. A wall clock inside a
DST gap takes the offset before the gap (utils/tz.py), as in the JAX
package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.batch import ColumnVector
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.utils import tz as TZ

__all__ = ["civil_from_days", "days_from_civil", "tz_offset_micros", "temporal_func",
           "format_timestamp_string"]

MU_DAY = 86_400_000_000
MU_SEC = 1_000_000

# functions that read a timestamp as the instant it is, whatever ``tz`` says
_NO_SHIFT = ("from_utc_timestamp", "to_utc_timestamp", "date_trunc", "from_unixtime",
             "unix_timestamp", "unix_micros", "unix_millis", "unix_seconds",
             "convert_timezone", "timestampadd", "timestampdiff")
_UNIT_MICROS = {"MICROSECOND": 1, "MILLISECOND": 1_000, "SECOND": MU_SEC, "MINUTE": 60 * MU_SEC,
                "HOUR": 3600 * MU_SEC, "DAY": MU_DAY, "WEEK": 7 * MU_DAY}
_UNIT_MONTHS = {"MONTH": 1, "QUARTER": 3, "YEAR": 12}
_DOW = {"mon": 0, "tue": 1, "wed": 2, "thu": 3, "fri": 4, "sat": 5, "sun": 6}


def civil_from_days(days: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day) as int32, Hinnant's
    algorithm in floor division."""
    z = days.long() + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y.int(), m.int(), d.int()


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    y, m, d = y.long(), m.long(), d.long()
    y_adj = torch.where(m <= 2, y - 1, y)
    era = torch.where(y_adj >= 0, y_adj, y_adj - 399) // 400
    yoe = y_adj - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


_TZ_TABLES: Dict[tuple, Tuple[Optional[torch.Tensor], torch.Tensor]] = {}


def tz_offset_micros(micros: torch.Tensor, tz: Optional[str], local: bool) -> torch.Tensor:
    """The UTC offset (µs) of each instant in ``tz``; ``local``: the input
    is a wall clock (the reverse lookup). A fixed-offset zone is one
    constant; a named zone's table is copied to the device once."""
    key = (tz or "UTC", local, str(micros.device))
    hit = _TZ_TABLES.get(key)
    if hit is None:
        trans, offs = (TZ.local_to_utc_offsets if local else TZ.utc_to_local_offsets)(tz or "UTC")
        hit = (torch.from_numpy(np.ascontiguousarray(trans, np.int64)).to(micros.device)
               if len(trans) else None,
               torch.from_numpy(offs.astype(np.int64) * MU_SEC).to(micros.device))
        _TZ_TABLES[key] = hit
    trans, offs = hit
    if trans is None:
        return offs[0].expand(micros.shape)
    idx = torch.searchsorted(trans, torch.div(micros, MU_SEC, rounding_mode="floor"), right=True)
    return offs[idx]


def format_timestamp_string(local_micros: torch.Tensor, validity: torch.Tensor) -> ColumnVector:
    """'yyyy-MM-dd HH:mm:ss' of each wall clock, as string(19)."""
    days = local_micros // MU_DAY
    secs = (local_micros - days * MU_DAY) // MU_SEC
    y, mo, d = (v.long() for v in civil_from_days(days))
    hh, mi, ss = secs // 3600, (secs // 60) % 60, secs % 60

    def dig(v, p):
        return (v // p) % 10 + ord("0")

    dash, colon, space = (torch.full_like(y, ord(c)) for c in "-: ")
    parts = [dig(y, 1000), dig(y, 100), dig(y, 10), dig(y, 1), dash, dig(mo, 10), dig(mo, 1),
             dash, dig(d, 10), dig(d, 1), space, dig(hh, 10), dig(hh, 1), colon, dig(mi, 10),
             dig(mi, 1), colon, dig(ss, 10), dig(ss, 1)]
    mat = torch.stack(parts, dim=1).to(torch.uint8)
    lens = torch.full(y.shape, 19, dtype=torch.int32, device=y.device)
    return ColumnVector(mat, validity, lens, T.string(19))


def _add_months(days: torch.Tensor, months: torch.Tensor) -> torch.Tensor:
    """The date ``months`` later, its day clamped to the target month's
    last (Spark's add_months)."""
    y, m, d = civil_from_days(days)
    tot = y.long() * 12 + (m.long() - 1) + months
    ny, nm = tot // 12, tot % 12 + 1
    nxt_y = torch.where(nm == 12, ny + 1, ny)
    nxt_m = torch.where(nm == 12, 1, nm + 1)
    one = torch.ones_like(nm)
    last = days_from_civil(nxt_y, nxt_m, one) - days_from_civil(ny, nm, one)
    return days_from_civil(ny, nm, torch.minimum(d.long(), last))


def _trunc_days(days: torch.Tensor, unit: str, fn: str) -> torch.Tensor:
    y, m, d = civil_from_days(days)
    one = torch.ones_like(d)
    if unit in ("year", "yyyy", "yy"):
        return days_from_civil(y, one, one)
    if unit == "quarter":
        return days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
    if unit in ("month", "mon", "mm"):
        return days_from_civil(y, m, one)
    if unit == "week":
        return days - (days + 3) % 7
    raise NotImplementedError(f"{fn} unit {unit}")


def temporal_func(e: E.TemporalFunc, args: List[ColumnVector]) -> ColumnVector:
    """One TemporalFunc over its evaluated arguments, branch by branch as
    JAX ``evaluator.py:2117-2378``."""
    f = e.func
    cv = args[0]
    validity = cv.validity
    if cv.dtype.type_id in ("TIMESTAMP", "TIMESTAMP_NTZ"):
        micros0 = cv.data.long()
        if e.tz and f not in _NO_SHIFT:
            micros0 = micros0 + tz_offset_micros(micros0, e.tz, local=False)
        days = micros0 // MU_DAY
        micros_in_day = micros0 - days * MU_DAY
    else:
        micros0 = None
        days = cv.data.long()
        micros_in_day = torch.zeros_like(days)

    def out(data, dt, valid=validity):
        return ColumnVector(data.to(torch.from_numpy(np.zeros(0, dt.np_dtype())).dtype), valid,
                            None, dt)

    if f in E.DATE_FIELDS:
        y, m, d = civil_from_days(days)
        if f == "year":
            data = y
        elif f == "month":
            data = m
        elif f == "day":
            data = d
        elif f == "quarter":
            data = (m - 1) // 3 + 1
        elif f == "dayofweek":  # 1 = Sunday; 1970-01-01 was a Thursday (5)
            data = (days + 4) % 7 + 1
        elif f == "dayofyear":
            data = days - days_from_civil(y, torch.ones_like(m), torch.ones_like(d)) + 1
        else:  # weekofyear (ISO 8601): the week of this week's Thursday
            thursday = days - (days + 3) % 7 + 3
            ty, _, _ = civil_from_days(thursday)
            data = (thursday - days_from_civil(ty, torch.ones_like(ty), torch.ones_like(ty))) \
                // 7 + 1
        return out(data, T.INT32)
    if f in ("hour", "minute", "second"):
        secs = micros_in_day // MU_SEC
        data = {"hour": secs // 3600, "minute": (secs // 60) % 60, "second": secs % 60}[f]
        return out(data, T.INT32)
    if f in ("date_add", "date_sub"):
        delta = args[1].data.long()
        return out(days + delta if f == "date_add" else days - delta, T.DATE,
                   validity & args[1].validity)
    if f == "datediff":
        return out(days - args[1].data.long(), T.INT32, validity & args[1].validity)
    if f == "unix_date":
        return out(days, T.INT32)
    if f == "weekday":  # 0 = Monday
        return out((days + 3) % 7, T.INT32)
    if f == "last_day":
        y, m, d = civil_from_days(days)
        ny = torch.where(m == 12, y + 1, y)
        nm = torch.where(m == 12, 1, m + 1)
        return out(days_from_civil(ny, nm, torch.ones_like(d)) - 1, T.DATE)
    if f == "trunc_date":
        unit = e.args[1].value.lower() if isinstance(e.args[1], E.Literal) else "month"
        return out(_trunc_days(days, unit, "trunc"), T.DATE)
    if f in ("from_utc_timestamp", "to_utc_timestamp"):
        tz = e.args[1].value if len(e.args) > 1 and isinstance(e.args[1], E.Literal) else e.tz
        micros = cv.data.long()
        off = tz_offset_micros(micros, tz, local=(f == "to_utc_timestamp"))
        data = micros + off if f == "from_utc_timestamp" else micros - off
        return out(data, T.TIMESTAMP_NTZ if f == "from_utc_timestamp" else T.TIMESTAMP)
    if f in ("unix_timestamp", "unix_micros", "unix_millis", "unix_seconds"):
        micros = micros0 if f == "unix_seconds" else cv.data.long()
        div = {"unix_timestamp": MU_SEC, "unix_micros": 1, "unix_millis": 1000,
               "unix_seconds": MU_SEC}[f]
        return out(micros // div, T.INT64)
    if f in ("timestamp_seconds", "timestamp_millis", "timestamp_micros"):
        mult = {"timestamp_seconds": MU_SEC, "timestamp_millis": 1000, "timestamp_micros": 1}[f]
        return out(cv.data.long() * mult, T.TIMESTAMP)
    if f == "date_trunc":  # (unit literal, ts): truncated on the wall clock
        unit = e.args[0].value.lower() if isinstance(e.args[0], E.Literal) else "day"
        ts = args[1]
        micros = ts.data.long()
        off = tz_offset_micros(micros, e.tz, local=False) if e.tz else 0
        local = micros + off
        ldays = local // MU_DAY
        if unit in ("second", "minute", "hour"):
            q = {"second": MU_SEC, "minute": 60 * MU_SEC, "hour": 3600 * MU_SEC}[unit]
            data = local - (local - ldays * MU_DAY) % q
        elif unit in ("day", "dd"):
            data = ldays * MU_DAY
        elif unit in ("week", "month", "mon", "mm", "quarter", "year", "yyyy", "yy"):
            data = _trunc_days(ldays, unit, "date_trunc") * MU_DAY
        else:
            raise NotImplementedError(f"date_trunc unit {unit}")
        return out(data - off, T.TIMESTAMP, ts.validity)
    if f == "add_months":
        return out(_add_months(days, args[1].data.long()), T.DATE, validity & args[1].validity)
    if f in ("timestampadd", "timestampdiff"):
        unit = (e.unit or "SECOND").upper()
        ok = validity & args[1].validity
        if f == "timestampadd":
            qty = args[1].data.long()
            if unit in _UNIT_MICROS:
                return out(micros0 + qty * _UNIT_MICROS[unit], T.TIMESTAMP, ok)
            out_days = _add_months(days, qty * _UNIT_MONTHS[unit])
            return out(out_days * MU_DAY + micros_in_day, T.TIMESTAMP, ok)
        end = args[1].data.long()
        if unit in _UNIT_MICROS:  # whole units, truncated toward zero
            diff = end - micros0
            return out(torch.sign(diff) * (diff.abs() // _UNIT_MICROS[unit]), T.INT64, ok)
        # calendar months between, truncated toward zero
        ed = end // MU_DAY
        y1, m1, d1 = civil_from_days(days)
        y2, m2, d2 = civil_from_days(ed)
        t1, t2 = micros0 - days * MU_DAY, end - ed * MU_DAY
        mdiff = (y2.long() - y1) * 12 + (m2.long() - m1)
        before = (d2 < d1) | ((d2 == d1) & (t2 < t1))
        after = (d2 > d1) | ((d2 == d1) & (t2 > t1))
        mdiff = torch.where((mdiff > 0) & before, mdiff - 1, mdiff)
        mdiff = torch.where((mdiff < 0) & after, mdiff + 1, mdiff)
        return out(torch.sign(mdiff) * (mdiff.abs() // _UNIT_MONTHS[unit]), T.INT64, ok)
    if f == "convert_timezone":  # the wall clock from zone tz to zone unit
        src, tgt = e.tz, e.unit
        inst = micros0 - tz_offset_micros(micros0, src, local=True) if src else micros0
        data = inst + tz_offset_micros(inst, tgt, local=False) if tgt else inst
        return out(data, T.TIMESTAMP_NTZ)
    if f == "months_between":
        t2 = args[1]
        if t2.dtype.type_id in ("TIMESTAMP", "TIMESTAMP_NTZ"):
            days2 = t2.data // MU_DAY
            mic2 = t2.data - days2 * MU_DAY
        else:
            days2 = t2.data.long()
            mic2 = torch.zeros_like(days2)
        y1, m1, d1 = civil_from_days(days)
        y2, m2, d2 = civil_from_days(days2)
        months = (y1 - y2) * 12 + (m1 - m2)
        both_last = (civil_from_days(days + 1)[1] != m1) & (civil_from_days(days2 + 1)[1] != m2)
        sec1 = d1.double() * 86400 + micros_in_day.double() / 1e6
        sec2 = d2.double() * 86400 + mic2.double() / 1e6
        frac = (sec1 - sec2) / (31.0 * 86400.0)
        res = months.double() + torch.where(both_last | (d1 == d2), 0.0, frac)
        return out(torch.round(res * 1e8) / 1e8, T.FLOAT64, validity & t2.validity)
    if f == "next_day":
        target = _DOW.get(str(e.args[1].value).lower()[:3])
        if target is None:
            return out(torch.zeros_like(days), T.DATE, torch.zeros_like(validity))
        delta = (target - (days + 3) % 7) % 7
        return out(days + torch.where(delta == 0, 7, delta), T.DATE)
    if f == "make_date":
        y, m, d = (a.data.long() for a in args)
        ok = (m >= 1) & (m <= 12) & (d >= 1) & (d <= 31)
        data = days_from_civil(y, m.clamp(1, 12), d.clamp(1, 31))
        ry, rm, rd = civil_from_days(data)  # Feb 30 and the like do not round-trip
        ok = ok & (ry.long() == y) & (rm.long() == m) & (rd.long() == d)
        return out(data, T.DATE, validity & args[1].validity & args[2].validity & ok)
    if f == "from_unixtime":
        micros = cv.data.long() * MU_SEC
        off = tz_offset_micros(micros, e.tz, local=False) if e.tz else 0
        return format_timestamp_string(micros + off, validity)
    raise NotImplementedError(f"temporal func {f}")

