"""PyTorch port, every TemporalFunc, TIMESTAMP with a session zone and the
timestamp casts (exec/temporal.py, exec/casts.py) against the JAX package
on the same seeded columns: DST transitions in America/New_York and
Europe/Berlin (a wall clock in a gap takes the offset before it, utils/tz.py),
fixed offsets, nulls and dead rows, held equal exactly; the offsets also
against Python's ``zoneinfo``."""

import datetime
import zoneinfo

import numpy as np
import pytest

from _torch_expr import assert_same, assert_same_errors, run_all, run_both, stage, values
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from datafusion_comet_tpu_torch.exec import temporal as TM

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MU = 1_000_000
ZONES = ("America/New_York", "Europe/Berlin", "+05:30")


def _instants():
    """Instants around the 2024 DST changes of both zones, far dates, the
    epoch and its neighbours, and seeded random ones (µs)."""
    edges = []
    for y, m, d, h in ((2024, 3, 10, 7), (2024, 11, 3, 6), (2024, 3, 31, 1), (2024, 10, 27, 1)):
        t = int(datetime.datetime(y, m, d, h, tzinfo=datetime.timezone.utc).timestamp()) * MU
        edges += [t - 1, t, t + 1, t - 3600 * MU, t + 1800 * MU]
    edges += [0, -1, 1, -86_400 * MU - 1, 951_782_400 * MU, 4_102_444_800 * MU + 123_456,
              -2_208_988_800 * MU + 7]
    rng = np.random.default_rng(17)
    rand = rng.integers(-2_000_000_000 * MU, 4_000_000_000 * MU, 40)
    return np.array(edges + list(rand), np.int64)


T_US = _instants()
N = len(T_US)
VALID = np.ones(N, bool)
VALID[[3, 11]] = False
MASK = np.ones(N, bool)
MASK[[5, 20]] = False


def _batches():
    rng = np.random.default_rng(3)
    data = {"t": T_US, "u": T_US[::-1].copy(), "d": (T_US // (86_400 * MU)).astype(np.int32),
            "i": rng.integers(-30, 30, N).astype(np.int32),
            "y": rng.integers(1990, 2030, N).astype(np.int32),
            "m": rng.integers(0, 14, N).astype(np.int32),
            "dd": rng.integers(0, 32, N).astype(np.int32)}
    fields = [("t", lambda T: T.TIMESTAMP), ("u", lambda T: T.TIMESTAMP),
              ("d", lambda T: T.DATE), ("i", lambda T: T.INT32), ("y", lambda T: T.INT32),
              ("m", lambda T: T.INT32), ("dd", lambda T: T.INT32)]
    return stage(fields, data, validity={"t": VALID}, mask=MASK)


def _cases():
    c = lambda E, n: E.col(n)  # noqa: E731
    out = []
    for f in ("year", "month", "day", "quarter", "dayofweek", "dayofyear", "weekofyear", "hour",
              "minute", "second", "unix_date", "weekday", "last_day", "unix_seconds"):
        for tz in (None,) + ZONES:
            out.append((f"{f}-{tz}", lambda E, f=f, tz=tz: E.TemporalFunc(f, (c(E, "t"),), tz)))
    for f in ("year", "dayofweek", "weekofyear", "last_day"):
        out.append((f"{f}-date", lambda E, f=f: E.TemporalFunc(f, (c(E, "d"),))))
    for f in ("unix_timestamp", "unix_micros", "unix_millis"):
        out.append((f, lambda E, f=f: E.TemporalFunc(f, (c(E, "t"),))))
    for f in ("timestamp_seconds", "timestamp_millis", "timestamp_micros"):
        out.append((f, lambda E, f=f: E.TemporalFunc(f, (c(E, "i"),))))
    for f in ("date_add", "date_sub", "add_months"):
        out.append((f, lambda E, f=f: E.TemporalFunc(f, (c(E, "d"), c(E, "i")))))
    out.append(("datediff", lambda E: E.TemporalFunc("datediff", (c(E, "d"), c(E, "i")))))
    for unit in ("year", "quarter", "month", "week"):
        out.append((f"trunc-{unit}", lambda E, u=unit: E.TemporalFunc(
            "trunc_date", (c(E, "d"), E.lit(u)))))
    for unit in ("second", "minute", "hour", "day", "week", "month", "quarter", "year"):
        for tz in (None,) + ZONES:
            out.append((f"date_trunc-{unit}-{tz}", lambda E, u=unit, tz=tz: E.TemporalFunc(
                "date_trunc", (E.lit(u), c(E, "t")), tz)))
    for tz in ZONES:
        for f in ("from_utc_timestamp", "to_utc_timestamp"):
            out.append((f"{f}-{tz}", lambda E, f=f, tz=tz: E.TemporalFunc(
                f, (c(E, "t"), E.lit(tz)))))
        out.append((f"from_unixtime-{tz}", lambda E, tz=tz: E.TemporalFunc(
            "from_unixtime", (c(E, "i"),), tz)))
        out.append((f"convert-{tz}", lambda E, tz=tz: E.TemporalFunc(
            "convert_timezone", (c(E, "t"),), "Europe/Berlin", tz)))
    for unit in ("SECOND", "HOUR", "DAY", "WEEK", "MONTH", "QUARTER", "YEAR"):
        out.append((f"add-{unit}", lambda E, u=unit: E.TemporalFunc(
            "timestampadd", (c(E, "t"), c(E, "i")), unit=u)))
        out.append((f"diff-{unit}", lambda E, u=unit: E.TemporalFunc(
            "timestampdiff", (c(E, "t"), c(E, "u")), unit=u)))
    out.append(("months_between-ts", lambda E: E.TemporalFunc("months_between",
                                                               (c(E, "t"), c(E, "u")))))
    out.append(("months_between-d", lambda E: E.TemporalFunc("months_between",
                                                              (c(E, "d"), c(E, "d")))))
    for day in ("Mon", "sunday", "xx"):
        out.append((f"next_day-{day}", lambda E, day=day: E.TemporalFunc(
            "next_day", (c(E, "d"), E.lit(day)))))
    out.append(("make_date", lambda E: E.TemporalFunc("make_date", (c(E, "y"), c(E, "m"),
                                                                    c(E, "dd")))))
    return out


CASES = _cases()


@pytest.mark.parametrize("chunk", range(4))
def test_temporal_funcs_equal_jax(chunk):
    """Every function, a quarter of the cases each (one batch, so the JAX
    side compiles each primitive once per file)."""
    jb, pb = _batches()
    cases = CASES[chunk::4]
    for (name, _), (j, p) in zip(cases, run_all([lambda E, T, b=b: b(E) for _, b in cases],
                                                 jb, pb)):
        assert_same(j, p, N)


@pytest.mark.parametrize("tz", ZONES[:2])
def test_offsets_equal_zoneinfo(tz):
    """The UTC offset of each instant, and the instant of each wall clock
    (outside gaps and overlaps), as zoneinfo has them, up to 2037: past the
    tables' last transition both packages keep its offset and do not read
    the zone file's rule for later years (ROADMAP C29)."""
    import torch

    zi = zoneinfo.ZoneInfo(tz)
    ts = T_US[T_US < 2_114_380_800 * MU]
    off = TM.tz_offset_micros(torch.from_numpy(ts), tz, local=False).numpy()
    for t, o in zip(ts, off):
        dt = datetime.datetime.fromtimestamp(int(t) // MU, zi)
        assert o == int(dt.utcoffset().total_seconds()) * MU, (t, o)
    wall = ts + off
    back = TM.tz_offset_micros(torch.from_numpy(wall), tz, local=True).numpy()
    for t, w, o, b in zip(ts, wall, off, back):
        naive = datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(w))
        a = naive.replace(tzinfo=zi, fold=0).utcoffset()
        z = naive.replace(tzinfo=zi, fold=1).utcoffset()
        if a == z:  # neither in a gap nor in an overlap
            assert b == o, (t, w)


def test_gap_takes_the_offset_before_it():
    """2024-03-10 02:30 in New York does not exist: the offset before the
    gap (EST, -5 h) applies, as in the JAX package (utils/tz.py)."""
    import torch

    wall = int((datetime.datetime(2024, 3, 10, 2, 30) - datetime.datetime(1970, 1, 1))
               .total_seconds()) * MU
    got = TM.tz_offset_micros(torch.tensor([wall]), "America/New_York", local=True)
    assert got.item() == -5 * 3600 * MU


@pytest.mark.parametrize("tz", [None, "America/New_York", "Europe/Berlin"])
def test_timestamp_casts_equal_jax(tz):
    """timestamp <-> string, date and numbers in a session zone, string
    parsing of the forms the JAX package takes, all three modes."""
    jb, pb = _batches()
    for to in ("STR", "DATE", "INT64", "FLOAT64", "INT32", "NTZSTR"):
        def build(E, T, to=to):
            if to == "NTZSTR":
                return E.Cast(E.TemporalFunc("from_utc_timestamp", (E.col("t"), E.lit("UTC"))),
                              T.string(32), E.EvalMode.LEGACY, tz)
            t = {"STR": T.string(32), "DATE": T.DATE, "INT64": T.INT64, "FLOAT64": T.FLOAT64,
                 "INT32": T.INT32}[to]
            return E.Cast(E.col("t"), t, E.EvalMode.LEGACY, tz)

        j, p = run_both(build, jb, pb)
        assert_same(j, p, N)
    for frm in ("d", "i"):
        for to in ("TIMESTAMP", "TIMESTAMP_NTZ"):
            j, p = run_both(lambda E, T: E.Cast(E.col(frm), getattr(T, to), E.EvalMode.LEGACY,
                                                tz), jb, pb)
            assert_same(j, p, N)
    # the rendered strings parse back to the instant
    j, p = run_both(lambda E, T: E.Cast(E.Cast(E.col("t"), T.string(32), E.EvalMode.LEGACY, tz),
                                        T.TIMESTAMP, E.EvalMode.LEGACY, tz), jb, pb)
    assert_same(j, p, N)
    pv, ok = values(p, N)
    for i in range(N):
        if ok[i] and MASK[i] and tz is None:
            assert pv[i] == T_US[i]


def test_string_to_timestamp_forms_and_modes():
    strs = np.array(["2024-03-10 02:30:00", "2024-03-10T07:15", "2024-11-03 01:30:00.5",
                     " 1999-12-31 23:59:59.999999 ", "2024-02-30", "2024-13-01 00:00",
                     "garbage", "", None, "2024-01-01", "2024-01-01 24:00", "1970-01-01 00:00:60",
                     "2024-06-01 12:00:00.1234567"], dtype=object)
    n = len(strs)
    for dict_strings in (False, True):
        jb, pb = stage([("s", lambda T: T.string(30))], {"s": strs}, dict_strings=dict_strings,
                       mask=np.arange(n) != 1)
        builds = [lambda E, T, to=to, tz=tz, mode=mode: E.Cast(E.col("s"), getattr(T, to), mode,
                                                               tz)
                  for mode in (("LEGACY",) if dict_strings else ("LEGACY", "ANSI", "TRY"))
                  for to, tz in (("TIMESTAMP", None), ("TIMESTAMP", "America/New_York"),
                                 ("TIMESTAMP_NTZ", None))[: 3 if mode == "LEGACY" else 2]]
        for j, p, je, pe in run_all(builds, jb, pb, mode_ctx=True):
            assert_same(j, p, n)
            assert_same_errors(je, pe)
