"""PyTorch port, strings that are not dictionary codes, exactly against the
JAX package on the same seeded numpy inputs:

- padded-string sort limbs (widths 1, 4, 10, 25 and 55: one int32 limb up
  to 4 bytes, then an int64 limb each 8 bytes) and the order they give;
- eq, ne, lt, le, gt, ge, eqns and IN on padded strings of two widths, a
  dictionary column against a padded one, two different dictionaries, and
  a literal on either side; CASE WHEN with a string result; the
  dictionary decode;
- murmur3 of strings, bit for bit (empty strings, every tail length,
  bytes of 0x80 and up, a dictionary column);
- a join on a string key (dictionary against padded) directly and over
  the budget: the same rows, K and partition sizes as the JAX package;
- TPC-H Q1, Q3, Q4, Q5 and Q12 with every string column padded
  (``dict_max_size=0``) through both packages' ``Session``s: values,
  order, storage and bounds, and the numpy oracles."""

import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec import evaluator as JEV
from datafusion_comet_tpu.exec import sortkeys as JS
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.exec import sortkeys as PS
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from test_torch_grace import jax_fraction, jax_spy  # noqa: F401 (jax_spy: a fixture)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 400
ALPHABET = [b"", b"a", b"ab", b"abc", b"abcd", b"abcde", b"b", b"\x80", b"\xff\x00",
            b"\x7f\x80\xff", b"zz\x81z", b"a\x00", b"abcdefgh"]


def _strings(rng, n, width, pool=None):
    """n byte strings of at most ``width`` bytes: a pool's values and random
    bytes (0x80 and up included), every length from 0 to ``width``."""
    out = []
    for i in range(n):
        if pool is not None and i % 3 == 0:
            out.append(pool[rng.integers(0, len(pool))][:width])
        else:
            out.append(bytes(rng.integers(0, 256, rng.integers(0, width + 1)).astype(np.uint8)))
    return np.array(out, dtype=object)


# ---- sort limbs -----------------------------------------------------------------------


def _padded_cv(M, B, mat, lens, width, device=None):
    if M is JT:
        import jax.numpy as jnp

        return B.ColumnVector(jnp.asarray(mat), jnp.ones(len(mat), bool), jnp.asarray(lens),
                              M.binary(width))
    return B.ColumnVector(torch.from_numpy(mat), torch.ones(len(mat), dtype=torch.bool),
                          torch.from_numpy(lens), M.binary(width))


@pytest.mark.parametrize("width", [1, 4, 10, 25, 55])
def test_padded_limbs_match_jax_and_sort_as_bytes(width):
    rng = np.random.default_rng(width)
    vals = _strings(rng, N, width, ALPHABET)
    mat, lens = PB._pad_strings_np(vals, width)
    jl = JS.column_limbs(_padded_cv(JT, JB, mat, lens, width))
    pl = PS.column_limbs(_padded_cv(PT, PB, mat, lens, width))
    assert len(pl) == len(jl) == (1 if width <= 4 else -(-width // 8))
    for a, b in zip(jl, pl):
        a = np.asarray(a)
        assert b.dtype == (torch.int32 if width <= 4 else torch.int64)
        np.testing.assert_array_equal(a, b.numpy())
    # the limbs order rows as their zero-padded bytes (no embedded NUL at
    # the end, so that is the strings' own order with prefixes first)
    perm = PS.lexsort(pl).numpy()
    keys = [bytes(mat[i]) for i in range(N)]
    assert [keys[i] for i in perm] == sorted(keys)
    assert perm.tolist() == sorted(range(N), key=lambda i: (keys[i], i))


# ---- comparisons, IN, CASE WHEN, decode -----------------------------------------------


def _cmp_schema(M):
    return M.Schema([M.Field("a", M.string(6)), M.Field("b", M.string(9)),
                     M.Field("d", M.string(6)), M.Field("e", M.string(9)),
                     M.Field("k", M.INT32)])


@pytest.fixture(scope="module")
def cmp_batches():
    """a, b: padded (200+ distinct values); d, e: dictionaries (at most 13
    values, two different dictionaries); nulls in every column; dead rows."""
    rng = np.random.default_rng(5)
    data = {"a": _strings(rng, N, 6, ALPHABET), "b": _strings(rng, N, 9, ALPHABET),
            "d": np.array(ALPHABET, object)[rng.integers(0, 8, N)],
            "e": np.array(ALPHABET, object)[rng.integers(3, 13, N)],
            "k": rng.integers(0, 4, N).astype(np.int32)}
    data["b"][::5] = data["a"][::5]  # equal pairs of two widths
    validity = {c: rng.random(N) > 0.1 for c in ("a", "b", "d", "e", "k")}
    jb = JB.from_numpy(data, _cmp_schema(JT), validity=validity, dict_max_size=20)
    pb = PB.from_numpy(data, _cmp_schema(PT), "cpu", validity=validity, dict_max_size=20)
    keep = rng.random(jb.capacity) > 0.1
    jb = jb.with_mask(jb.row_mask & keep)
    pb = pb.with_mask(pb.row_mask & torch.from_numpy(keep))
    assert [c.is_dict for c in pb.columns] == [False, False, True, True, False]
    assert [c.is_dict for c in jb.columns] == [False, False, True, True, False]
    return jb, pb


def _same_cv(j, p, live):
    """Equal validity and, on valid live rows, equal values (and lengths)."""
    jv, pv = np.asarray(j.validity)[live], p.validity.numpy()[live]
    np.testing.assert_array_equal(jv, pv)
    jd, pd = np.asarray(j.data)[live][jv], p.data.numpy()[live][pv]
    np.testing.assert_array_equal(jd, pd)
    assert (j.lengths is None) == (p.lengths is None)
    if p.lengths is not None:
        np.testing.assert_array_equal(np.asarray(j.lengths)[live][jv], p.lengths.numpy()[live][pv])


def _both(cmp_batches, build):
    jb, pb = cmp_batches
    je = JE.bind(build(JE, JT), jb.schema)
    pe = PE.bind(build(PE, PT), pb.schema)
    return JEV.evaluate(je, jb), PEV.evaluate(pe, pb), np.asarray(jb.row_mask)


OPS = ("eq", "ne", "lt", "le", "gt", "ge", "eqns")
PAIRS = {
    "padded_widths": lambda E, M: (E.col("a"), E.col("b")),
    "dict_padded": lambda E, M: (E.col("d"), E.col("b")),
    "padded_dict": lambda E, M: (E.col("a"), E.col("e")),
    "two_dicts": lambda E, M: (E.col("d"), E.col("e")),
    "one_dict": lambda E, M: (E.col("d"), E.col("d")),
    "literal_right": lambda E, M: (E.col("a"), E.lit("abc")),
    "literal_left": lambda E, M: (E.lit(b"\x80", M.string(1)), E.col("b")),
    "dict_literal": lambda E, M: (E.lit("ab"), E.col("d")),
}


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("op", OPS)
def test_string_comparisons_match_jax(cmp_batches, op, pair):
    def build(E, M):
        l, r = PAIRS[pair](E, M)
        return E.BinaryOp(op, l, r)

    j, p, live = _both(cmp_batches, build)
    _same_cv(j, p, live)
    live_valid = p.validity.numpy() & live
    hits = p.data.numpy()[live_valid]
    # both outcomes occur, except where a column meets itself
    assert 0 < hits.sum() < len(hits) or pair == "one_dict"


@pytest.mark.parametrize("col", ["a", "d"])
@pytest.mark.parametrize("negated", [False, True])
def test_in_list_on_strings_matches_jax(cmp_batches, col, negated):
    def build(E, M):
        return E.InList(E.col(col), (E.lit("ab"), E.lit(b"\xff\x00", M.string(2)), E.lit(""),
                                     E.col("b")), negated)

    j, p, live = _both(cmp_batches, build)
    _same_cv(j, p, live)


CASES = {
    # literals of three widths, else a padded column
    "literals_else_column": lambda E: E.CaseWhen(
        ((E.col("k") == E.lit(0), E.lit("x")), (E.col("k") == E.lit(1), E.lit("longer!"))),
        E.col("a")),
    # a dictionary branch, a padded branch of another width, no else
    "dict_and_padded": lambda E: E.CaseWhen(
        ((E.col("a") < E.col("b"), E.col("d")), (E.col("k") > E.lit(1), E.col("b"))), None),
    # only dictionary branches (still decoded, as in the JAX package)
    "dicts_only": lambda E: E.CaseWhen(((E.col("k") == E.lit(2), E.col("e")),), E.col("d")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_case_when_with_a_string_result_matches_jax(cmp_batches, case):
    j, p, live = _both(cmp_batches, lambda E, _: CASES[case](E))
    assert p.lengths is not None and not p.is_dict
    assert p.data.shape == np.asarray(j.data).shape
    _same_cv(j, p, live)


@pytest.mark.parametrize("col,width", [("d", None), ("e", None), ("d", 3), ("e", 12)])
def test_dictionary_decode_matches_jax(cmp_batches, col, width):
    jb, pb = cmp_batches
    jc, pc = jb.column(col), pb.column(col)
    jm, jl = jc.dictionary.decode_arrays(jc.data, width)
    pm, pl = pc.dictionary.decode_arrays(pc.data, width)
    np.testing.assert_array_equal(np.asarray(jm), pm.numpy())
    np.testing.assert_array_equal(np.asarray(jl), pl.numpy())
    # one device copy of the dictionary per device and width
    assert pc.dictionary.device_arrays(pc.data.device, width or pc.dictionary.width)[0] \
        is pc.dictionary.device_arrays(pc.data.device, width or pc.dictionary.width)[0]
    dec = pc.decode()
    assert not dec.is_dict and dec.data.shape[1] == pc.dtype.byte_width
    _same_cv(jc.decode(), dec, np.asarray(jb.row_mask))
    assert pb.decode_dicts().columns[2].lengths is not None


def test_concat_of_different_dictionaries_decodes(cmp_batches):
    """Union pieces whose dictionaries differ: decoded and concatenated (JAX
    ``unify_encoding``); pieces of one dictionary stay codes."""
    _, pb = cmp_batches
    d, e = pb.column("d"), pb.column("e")
    mixed = PB._concat_column([d, e], PT.string(9))
    assert not mixed.is_dict and mixed.data.shape == (2 * pb.capacity, 9)
    want = PB._concat_column([d.decode(), e.decode()], PT.string(9))
    assert torch.equal(mixed.data, want.data) and torch.equal(mixed.lengths, want.lengths)
    same = PB._concat_column([d, d], PT.string(6))
    assert same.is_dict and same.dictionary == d.dictionary


# ---- murmur3 of strings ---------------------------------------------------------------


@pytest.mark.parametrize("width", [0, 1, 3, 4, 5, 8, 9, 25])
def test_murmur3_of_bytes_matches_jax_bit_for_bit(width):
    import jax.numpy as jnp

    rng = np.random.default_rng(100 + width)
    vals = _strings(rng, N, width, ALPHABET) if width else np.array([b""] * N, object)
    mat, lens = PB._pad_strings_np(vals, width)
    seed = rng.integers(-(1 << 31), 1 << 31, N).astype(np.int32)
    want = np.asarray(JEV.murmur3_hash_bytes(jnp.asarray(mat), jnp.asarray(lens),
                                             jnp.asarray(seed), width))
    got = PEV.murmur3_hash_bytes(torch.from_numpy(mat), torch.from_numpy(lens),
                                 torch.from_numpy(seed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    if width >= 4:  # every tail length and high bytes are present
        assert set(lens % 4) == {0, 1, 2, 3} and (mat >= 0x80).any()


@pytest.mark.parametrize("col", ["a", "b", "d", "e"])
def test_murmur3_column_of_strings_matches_jax(cmp_batches, col):
    """The column hash: a dictionary column decoded first, a null row
    leaving the running seed as it was (Spark)."""
    import jax.numpy as jnp

    jb, pb = cmp_batches
    seed = np.random.default_rng(9).integers(-(1 << 31), 1 << 31, jb.capacity).astype(np.int32)
    want = JEV._murmur3_column(jb.column(col), jnp.asarray(seed))
    got = PEV.murmur3_column(pb.column(col), torch.from_numpy(seed))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---- a join on a string key, directly and over the budget -----------------------------


def _key_tables(M):
    """fact (2,000 rows) joined to dim (300 rows) on a string key: the fact
    key padded (more distinct values than the dictionary limit), the dim
    key a dictionary; duplicate dim keys."""
    rng = np.random.default_rng(17)
    names = np.array([f"key-{i:05d}-é" for i in range(500)], object)
    fact = {"fk": names[rng.integers(0, 500, 2000)], "v": rng.integers(0, 1000, 2000)}
    dim = {"pk": names[rng.permutation(500)[:150].repeat(2)], "w": np.arange(300)}
    fs = M.Schema([M.Field("fk", M.string(12)), M.Field("v", M.INT64)])
    ds = M.Schema([M.Field("pk", M.string(12)), M.Field("w", M.INT64)])
    return {"fact": (fact, fs), "dim": (dim, ds)}


def _key_plan(P, E, tables):
    j = P.HashJoin(P.Scan("fact", tables["fact"][1]), P.Scan("dim", tables["dim"][1]),
                   (E.col("fk"),), (E.col("pk"),), P.JoinType.INNER, "right")
    return j.aggregate([E.col("fk")], [E.AggExpr("sum", E.col("v"), "sv"),
                                       E.AggExpr("count", E.col("w"), "n")])


def _register(sess, tables, **kw):
    for name, (data, schema) in tables.items():
        sess.register_numpy(name, data, schema, dict_max_size=200 if name == "dim" else 100,
                            **kw)


def test_string_key_join_direct_and_grace_match_jax(jax_spy):
    jt, pt = _key_tables(JT), _key_tables(PT)
    direct = Session(device="cpu")
    _register(direct, pt)
    assert [direct.tables[t].columns[0].is_dict for t in ("fact", "dim")] == [False, True]
    plan = _key_plan(PP, PE, pt)
    got_direct = direct.collect(plan)
    fraction, _ = chip_smoke.grace_fraction(direct, plan, 16)
    grace = Session(device="cpu", conf=Config(memory_fraction=fraction))
    _register(grace, pt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got_grace = grace.collect(plan)
    js = JaxSession()
    _register(js, jt)
    want = js.collect(_key_plan(JP, JE, jt))
    with jax_fraction(fraction):
        got_jax = js.collect(_key_plan(JP, JE, jt))
    (runner,) = grace.grace_runners
    assert [(runner.K, runner.downstream[0])] == list(jax_spy) == [(16, "local")]
    for got_sizes, want_sizes in zip(runner.sizes, jax_spy.sizes[0]):
        np.testing.assert_array_equal(got_sizes, want_sizes)
    assert 140 <= len(want["fk"]) <= 150  # the dim keys the fact side holds
    # the grace runs union the pairs' groups in partition order, both alike
    for w, g in ((want, got_direct), (got_jax, got_grace)):
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_array_equal(w[k], g[k], err_msg=k)
    order = np.argsort(got_grace["fk"].astype(str), kind="stable")
    for k in want:
        np.testing.assert_array_equal(want[k], got_grace[k][order], err_msg=k)


# ---- TPC-H with every string padded ---------------------------------------------------

NAMES = ("lineitem", "orders", "customer", "supplier", "nation", "region")


@pytest.fixture(scope="module")
def padded_sessions():
    data = tpch.generate_tables(NAMES, 0.01)
    js, ps = JaxSession(), Session(device="cpu", conf=Config(scan_dictionary_max_size=0))
    for t in NAMES:
        js.register_numpy(t, data[t], JTPCH.SCHEMAS[t], dict_max_size=0)
        ps.register_numpy(t, data[t], tpch.SCHEMAS[t])
    assert not any(c.is_dict for t in NAMES for c in ps.tables[t].columns)
    return js, ps, data


def _oracle_check(q, out, d):
    li, od, cu = d["lineitem"], d["orders"], d["customer"]
    if q == "q1":
        chip_smoke.check_q1(out, chip_smoke.oracle_q1(li, tpch._d("1998-09-02")))
    elif q == "q3":
        chip_smoke.check_q3(out, chip_smoke.oracle_q3(li, od, cu, tpch._d("1995-03-15")), q)
    elif q == "q4":
        chip_smoke.check_q4(out, chip_smoke.oracle_q4(li, od, tpch._d("1993-07-01"),
                                                      tpch._d("1993-10-01")), q)
    elif q == "q5":
        chip_smoke.check_q5(out, chip_smoke.oracle_q5(*(d[t] for t in NAMES), tpch._d("1994-01-01"),
                                                      tpch._d("1995-01-01")), q)
    else:
        chip_smoke.check_q12(out, chip_smoke.oracle_q12(li, od, tpch._d("1994-01-01"),
                                                        tpch._d("1995-01-01")), q)


@pytest.mark.parametrize("q", ["q1", "q3", "q4", "q5", "q12"])
def test_queries_with_padded_strings_match_jax_and_oracle(padded_sessions, q):
    js, ps, data = padded_sessions
    jb, pb = js.execute(getattr(JTPCH, q)()), ps.execute(getattr(tpch, q)())
    want, got = JB.to_numpy(jb), PB.to_numpy(pb)
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    for jc, pc, f in zip(jb.columns, pb.columns, pb.schema.fields):
        assert np.asarray(jc.data).ndim == pc.data.dim(), f.name
        assert jc.mag_bound == pc.mag_bound, f.name
        assert (jc.lengths is None) == (pc.lengths is None), f.name
    _oracle_check(q, got, data)
