"""PyTorch port, LIKE and the fields of a DATE, exactly against the JAX
package on the same seeded inputs:

- LIKE through the device evaluator (``evaluator._like``: a dictionary
  column matched over its entries, a padded column over its byte matrix)
  and through the host evaluator of the runtime filters
  (``host_filter._like_mask``), held to JAX ``_like_cv``, JAX
  ``host_filter._like_mask`` and a Python ``re`` oracle: prefix, suffix,
  contains, several segments, '_', patterns of only '%', the empty
  pattern, NOT LIKE; over a dictionary column and padded columns of widths
  1, 10, 25 and 55, nulls and dead rows included;
- '_' matches one byte in both packages, not one character as in Spark
  (ROADMAP C10): on a non-ASCII string the two differ from the oracle
  over characters alike;
- year, month, day, quarter, dayofweek, dayofyear and weekofyear of dates
  from 1600 to 2400 (1970-01-01, and Feb 28 / 29 / Mar 1 of 1900, 2000,
  2004 and 2100 among them), held to the JAX evaluator and to Python's
  ``datetime``; the fields of a timestamp too (every temporal function:
  tests/test_torch_temporal.py), and an unknown unit raises in both."""

import datetime
import re

import numpy as np
import pytest
import torch

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec import evaluator as JEV
from datafusion_comet_tpu.exec import host_filter as JHF
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.exec import host_filter as PHF
from datafusion_comet_tpu_torch.ir import expr as PE
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 300
PATTERNS = ["ab%", "%ab", "%ab%", "a%b%c", "a%b", "%a%b%c%", "a_c", "_b%", "%a_b%", "a__",
            "%c_", "_", "%", "%%", "", "abc", "ba%a%"]
STAGINGS = ["dict", 1, 10, 25, 55]


def _column(staging, seed):
    """(values, width, dict_max_size): N strings over 'abcx' of every length
    up to the width (25 for the dictionary column), one in 17 null."""
    width = 25 if staging == "dict" else staging
    rng = np.random.default_rng(seed)
    vals = np.array(["".join(rng.choice(list("abcx"), rng.integers(0, width + 1)))
                     for _ in range(N)], dtype=object)
    vals[::17] = None
    return vals, width, (1 << 16 if staging == "dict" else 0)


def _oracle(pattern: str, values) -> np.ndarray:
    """LIKE over characters: '%' any run, '_' one character."""
    rx = re.compile("".join(".*" if c == "%" else "." if c == "_" else re.escape(c)
                            for c in pattern), re.DOTALL)
    return np.array([v is not None and rx.fullmatch(v) is not None for v in values], bool)


def _batches(values, width, dms):
    data = {"s": values}
    js = JT.Schema([JT.Field("s", JT.string(width))])
    ps = PT.Schema([PT.Field("s", PT.string(width))])
    return (JB.from_numpy(data, js, dict_max_size=dms), js,
            PB.from_numpy(data, ps, "cpu", dict_max_size=dms), ps)


def _live(cv_data, cv_valid, n):
    return np.asarray(cv_data)[:n] & np.asarray(cv_valid)[:n]


@pytest.mark.parametrize("negated", [False, True])
@pytest.mark.parametrize("staging", STAGINGS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_like_matches_jax_and_oracle(pattern, staging, negated):
    values, width, dms = _column(staging, PATTERNS.index(pattern))
    jb, js, pb, ps = _batches(values, width, dms)
    assert pb.columns[0].is_dict == (staging == "dict") == jb.columns[0].is_dict
    want = JEV.evaluate(JE.bind(JE.Like(JE.col("s"), pattern, negated), js), jb)
    got = PEV.evaluate(PE.bind(PE.Like(PE.col("s"), pattern, negated), ps), pb)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.validity.numpy(), np.asarray(want.validity))
    valid = np.array([v is not None for v in values])
    hit = _oracle(pattern, values)
    expect = (~hit & valid) if negated else hit
    np.testing.assert_array_equal(_live(got.data.numpy(), got.validity.numpy(), N), expect)
    # the runtime filters' host evaluator, both packages
    pcol = PHF.HostColumns(pb).get("s")
    jcol = JHF.HostColumns(jb).get("s")
    host = PHF._like_mask(pcol, pattern)
    np.testing.assert_array_equal(host, JHF._like_mask(jcol, pattern))
    np.testing.assert_array_equal(host[:N] & valid, hit)


def test_like_over_the_dictionary_runs_on_its_entries():
    """A dictionary column's LIKE evaluates the entries once each and
    gathers by code (``_eval_on_dict``); dead rows past N stay false."""
    values, width, dms = _column("dict", 0)
    _, _, pb, ps = _batches(values, width, dms)
    d = pb.columns[0].dictionary
    assert d.size < N
    got = PEV.evaluate(PE.bind(PE.col("s").like("%a%"), ps), pb)
    entries = np.array([b"a" in d.value_of(c) for c in range(d.size)])
    codes = pb.columns[0].data.numpy()
    np.testing.assert_array_equal(got.data.numpy(), entries[codes])


# the non-ASCII strings of the C10 case: 'é' is two bytes, '€' three
C10_VALUES = np.array(["é", "aé", "éa", "a", "ab", "€", "x€y", None], dtype=object)


@pytest.mark.parametrize("staging", ["dict", "padded"])
def test_underscore_matches_one_byte_in_both_packages(staging):
    """ROADMAP C10: '_' is one byte in both packages (JAX
    ``evaluator.py:1549``, ``host_filter.py:219``), one character in Spark:
    '_' misses 'é' and 'a_' misses 'aé'; '__' hits 'é' and misses 'aé',
    '___' hits '€' and misses 'x€y'.
    Both packages agree on every row, and differ from the oracle over
    characters exactly there."""
    dms = 1 << 16 if staging == "dict" else 0
    jb, js, pb, ps = _batches(C10_VALUES, 10, dms)
    diffs = {}
    for pattern in ("_", "a_", "_a", "__", "___", "x_y", "%_%"):
        want = JEV.evaluate(JE.bind(JE.col("s").like(pattern), js), jb)
        got = PEV.evaluate(PE.bind(PE.col("s").like(pattern), ps), pb)
        n = len(C10_VALUES)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        host = PHF._like_mask(PHF.HostColumns(pb).get("s"), pattern)
        live = _live(got.data.numpy(), got.validity.numpy(), n)
        np.testing.assert_array_equal(host[:n] & np.asarray(got.validity)[:n], live)
        chars = _oracle(pattern, C10_VALUES)
        diffs[pattern] = [v for v, a, b in zip(C10_VALUES, live, chars) if a != b]
    assert diffs == {"_": ["é", "€"], "a_": ["aé"], "_a": ["éa"], "__": ["é", "aé", "éa"],
                     "___": ["aé", "éa", "€", "x€y"], "x_y": ["x€y"], "%_%": []}


# -- the fields of a DATE ---------------------------------------------------------

_EPOCH = datetime.date(1970, 1, 1)


def _days():
    rng = np.random.default_rng(5)
    lo, hi = (datetime.date(1600, 1, 1) - _EPOCH).days, (datetime.date(2400, 12, 31) - _EPOCH).days
    picked = [(datetime.date(y, m, d) - _EPOCH).days
              for y in (1900, 2000, 2004, 2100) for m, d in ((2, 28), (3, 1))]
    picked += [(datetime.date(y, 2, 29) - _EPOCH).days for y in (2000, 2004, 1600, 2400)]
    picked += [-1, 0, 1, lo, hi] + [(datetime.date(y, 12, 31) - _EPOCH).days + k
                                   for y in (1969, 2008, 2009, 2099) for k in range(-3, 5)]
    return np.concatenate([np.array(picked), rng.integers(lo, hi + 1, 700)]).astype(np.int32)


def _field(f: str, day: datetime.date) -> int:
    return {"year": day.year, "month": day.month, "day": day.day,
            "quarter": (day.month - 1) // 3 + 1, "dayofweek": day.isoweekday() % 7 + 1,
            "dayofyear": day.timetuple().tm_yday, "weekofyear": day.isocalendar()[1]}[f]


@pytest.mark.parametrize("f", PE.DATE_FIELDS)
def test_date_field_matches_jax_and_datetime(f):
    days = _days()
    valid = np.ones(len(days), bool)
    valid[7::50] = False
    data = {"d": days}
    jb = JB.from_numpy(data, JT.Schema([JT.Field("d", JT.DATE)]), validity={"d": valid})
    pb = PB.from_numpy(data, PT.Schema([PT.Field("d", PT.DATE)]), "cpu", validity={"d": valid})
    want = JEV.evaluate(JE.bind(JE.TemporalFunc(f, (JE.col("d"),)), jb.schema), jb)
    expr = PE.bind(PE.TemporalFunc(f, (PE.col("d"),)), pb.schema)
    assert expr.dtype == PT.INT32
    got = PEV.evaluate(expr, pb)
    assert got.data.dtype == torch.int32 and got.dtype == PT.INT32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.validity.numpy(), np.asarray(want.validity))
    expect = [_field(f, _EPOCH + datetime.timedelta(days=int(x))) for x in days]
    np.testing.assert_array_equal(got.data.numpy()[:len(days)], expect)


def test_timestamps_and_other_temporal_funcs_raise():
    """A timestamp's year and hour now equal the JAX package's; a unit
    neither package knows raises in both."""
    t = np.array([0, 86_400_000_000, -1, 1_700_000_000_123_456], np.int64)
    jb = JB.from_numpy({"t": t}, JT.Schema([JT.Field("t", JT.TIMESTAMP)]))
    pb = PB.from_numpy({"t": t}, PT.Schema([PT.Field("t", PT.TIMESTAMP)]), "cpu")
    for f in ("year", "hour"):
        want = JEV.evaluate(JE.bind(JE.TemporalFunc(f, (JE.col("t"),)), jb.schema), jb)
        got = PEV.evaluate(PE.bind(PE.TemporalFunc(f, (PE.col("t"),)), pb.schema), pb)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    for E, EV, b in ((JE, JEV, jb), (PE, PEV, pb)):
        with pytest.raises(NotImplementedError):
            EV.evaluate(E.bind(E.TemporalFunc("date_trunc", (E.lit("fortnight"), E.col("t"))),
                               b.schema), b)
