"""Time zones: TZif (RFC 8536) transition tables (port of
``datafusion_comet_tpu/utils/tz.py``; host side only, numpy).

A time zone name is a plan-time constant, so its transition history is
parsed on the host from the system tzdata (``TZDIR``, else
/usr/share/zoneinfo) into two sorted arrays: UTC transition instants and
UTC offsets. The evaluator converts a column with one ``torch.searchsorted``
and a gather (exec/evaluator.py ``_tz_offset_micros``).

Local→UTC reverse lookup uses the offset in force *before* each transition
(Java's ZonedDateTime overlap rule picks the earlier offset; for gap
instants we match the pre-gap offset — same as Spark for the overlap case,
documented deviation for nonexistent times inside a DST gap).

Fixed-offset forms ("UTC", "GMT", "+08:00", "UTC+8", "-05:30") never touch
tzdata.
"""

from __future__ import annotations

import os
import re
import struct
from functools import lru_cache
from typing import Tuple

import numpy as np

__all__ = ["tz_tables", "utc_to_local_offsets", "local_to_utc_offsets"]

_TZDIR = os.environ.get("TZDIR", "/usr/share/zoneinfo")

_FIXED_RE = re.compile(r"^(?:UTC|GMT)?([+-])(\d{1,2})(?::?(\d{2}))?$")


@lru_cache(maxsize=256)
def tz_tables(tz: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transitions_utc_seconds int64[N], offsets_seconds int32[N+1]).
    offsets[i] applies to instants in [transitions[i-1], transitions[i])."""
    tz = (tz or "UTC").strip()
    if tz.upper() in ("UTC", "GMT", "Z", "+00:00"):
        return np.zeros(0, np.int64), np.zeros(1, np.int32)
    m = _FIXED_RE.match(tz)
    if m:
        sign = -1 if m.group(1) == "-" else 1
        secs = sign * (int(m.group(2)) * 3600 + int(m.group(3) or 0) * 60)
        return np.zeros(0, np.int64), np.array([secs], np.int32)
    path = os.path.join(_TZDIR, tz)
    if not os.path.exists(path):
        raise ValueError(f"unknown timezone {tz!r} (no tzdata at {path})")
    with open(path, "rb") as f:
        data = f.read()
    return _parse_tzif(data)


def _parse_tzif(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    if data[:4] != b"TZif":
        raise ValueError("not a TZif file")
    version = data[4:5]

    def parse_block(buf, off, time_size):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt) = struct.unpack(
            ">6I", buf[off + 20 : off + 44]
        )
        p = off + 44
        fmt = ">%d%s" % (timecnt, "q" if time_size == 8 else "l")
        trans = np.array(struct.unpack(fmt, buf[p : p + timecnt * time_size]), np.int64)
        p += timecnt * time_size
        idxs = np.frombuffer(buf[p : p + timecnt], np.uint8)
        p += timecnt
        ttinfos = []
        for i in range(typecnt):
            utoff, isdst, abbrind = struct.unpack(">lBB", buf[p : p + 6])
            ttinfos.append(utoff)
            p += 6
        p += charcnt + leapcnt * (time_size + 4) + isstdcnt + isutcnt
        return trans, idxs, np.array(ttinfos, np.int32), p

    trans, idxs, offs, end = parse_block(data, 0, 4)
    if version in (b"2", b"3") :
        # v2+ block follows with 64-bit times — prefer it
        trans, idxs, offs, _ = parse_block(data, end, 8)
    if len(offs) == 0:
        return np.zeros(0, np.int64), np.zeros(1, np.int32)
    # offsets[i] = offset in force before transitions[i]; first entry = the
    # pre-history offset (TZif: first non-DST type, else type 0)
    first = offs[0]
    seq = np.empty(len(trans) + 1, np.int32)
    seq[0] = first
    if len(trans):
        seq[1:] = offs[idxs]
    return trans, seq


def utc_to_local_offsets(tz: str):
    """Arrays for instant→wall conversion: offsets[searchsorted(trans, t, 'right')]."""
    return tz_tables(tz)


@lru_cache(maxsize=256)
def local_to_utc_offsets(tz: str) -> Tuple[np.ndarray, np.ndarray]:
    """Transition boundaries expressed in *local* seconds, with the offset in
    force before each boundary (earlier-offset rule for overlaps)."""
    trans, offs = tz_tables(tz)
    if len(trans) == 0:
        return trans, offs
    # boundary in local time of transition i = trans[i] + offset AFTER it —
    # using the post-offset makes overlaps resolve to the earlier offset
    local_bounds = trans + offs[1:].astype(np.int64)
    # ensure monotonic (clock-back transitions create overlaps; keep sorted)
    local_bounds = np.maximum.accumulate(local_bounds)
    return local_bounds, offs
