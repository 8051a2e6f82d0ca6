"""TPC-H workload subset: the ``lineitem``, ``orders``, ``customer``,
``supplier``, ``nation``, ``region``, ``part`` and ``partsupp`` schemas and
generators, and the plans of Q1-Q22 (port of
``datafusion_comet_tpu/models/tpch.py``; ``QUERIES`` lists them).

The generator is a line-for-line copy of the JAX package's, so the same
``(sf, seed)`` gives bit-identical columns in both packages: results can be
compared across them, and checked on a machine without JAX.
"""

from __future__ import annotations

import datetime
import zlib
from typing import Dict

import numpy as np

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir import plan as P

__all__ = ["SCHEMAS", "QUERIES", "table_rows", "generate_table", "generate_tables", "q1", "q2",
           "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10", "q11", "q12", "q13", "q14", "q15",
           "q16", "q17", "q18", "q19", "q20", "q21", "q22"]

_dec = T.decimal

SCHEMAS: Dict[str, T.Schema] = {
    "lineitem": T.Schema(
        [
            T.Field("l_orderkey", T.INT64, False),
            T.Field("l_partkey", T.INT64, False),
            T.Field("l_suppkey", T.INT64, False),
            T.Field("l_linenumber", T.INT32, False),
            T.Field("l_quantity", _dec(15, 2), False),
            T.Field("l_extendedprice", _dec(15, 2), False),
            T.Field("l_discount", _dec(15, 2), False),
            T.Field("l_tax", _dec(15, 2), False),
            T.Field("l_returnflag", T.string(1), False),
            T.Field("l_linestatus", T.string(1), False),
            T.Field("l_shipdate", T.DATE, False),
            T.Field("l_commitdate", T.DATE, False),
            T.Field("l_receiptdate", T.DATE, False),
            T.Field("l_shipmode", T.string(10), False),
        ]
    ),
    "orders": T.Schema(
        [
            T.Field("o_orderkey", T.INT64, False),
            T.Field("o_custkey", T.INT64, False),
            T.Field("o_orderstatus", T.string(1), False),
            T.Field("o_totalprice", _dec(15, 2), False),
            T.Field("o_orderdate", T.DATE, False),
            T.Field("o_orderpriority", T.string(15), False),
            T.Field("o_shippriority", T.INT32, False),
        ]
    ),
    "customer": T.Schema(
        [
            T.Field("c_custkey", T.INT64, False),
            T.Field("c_name", T.string(25), False),
            T.Field("c_nationkey", T.INT64, False),
            T.Field("c_acctbal", _dec(15, 2), False),
            T.Field("c_mktsegment", T.string(10), False),
            T.Field("c_phone", T.string(15), False),
        ]
    ),
    "supplier": T.Schema(
        [
            T.Field("s_suppkey", T.INT64, False),
            T.Field("s_name", T.string(25), False),
            T.Field("s_nationkey", T.INT64, False),
            T.Field("s_acctbal", _dec(15, 2), False),
            T.Field("s_comment", T.string(60), False),
        ]
    ),
    "nation": T.Schema(
        [
            T.Field("n_nationkey", T.INT64, False),
            T.Field("n_name", T.string(25), False),
            T.Field("n_regionkey", T.INT64, False),
        ]
    ),
    "region": T.Schema(
        [
            T.Field("r_regionkey", T.INT64, False),
            T.Field("r_name", T.string(25), False),
        ]
    ),
    "part": T.Schema(
        [
            T.Field("p_partkey", T.INT64, False),
            T.Field("p_name", T.string(55), False),
            T.Field("p_brand", T.string(10), False),
            T.Field("p_type", T.string(25), False),
            T.Field("p_size", T.INT32, False),
            T.Field("p_container", T.string(10), False),
            T.Field("p_retailprice", _dec(15, 2), False),
        ]
    ),
    "partsupp": T.Schema(
        [
            T.Field("ps_partkey", T.INT64, False),
            T.Field("ps_suppkey", T.INT64, False),
            T.Field("ps_availqty", T.INT32, False),
            T.Field("ps_supplycost", _dec(15, 2), False),
        ]
    ),
}

_NATIONS = [
    "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA", "FRANCE",
    "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN", "JORDAN", "KENYA",
    "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA",
    "VIETNAM", "RUSSIA", "UNITED KINGDOM", "UNITED STATES",
]
_NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3, 4, 2, 3, 3, 1]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECI", "5-LOW"]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]

# the spec's 92 P_NAME words (TPC-H clause 4.2.3): a part's name is five of
# them, so LIKE '%green%' (Q9) keeps about 5% of the parts
_P_NAME_WORDS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow"
).split()
_CONTAINER_SIZES = ("SM", "LG", "MED", "JUMBO", "WRAP")
_CONTAINER_KINDS = ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM")


def _d(datestr: str) -> int:
    """'yyyy-mm-dd' → days since epoch."""
    return (datetime.date.fromisoformat(datestr) - datetime.date(1970, 1, 1)).days


def table_rows(name: str, sf: float) -> int:
    base = {
        "lineitem": 6_000_000,
        "orders": 1_500_000,
        "customer": 150_000,
        "supplier": 10_000,
        "part": 200_000,
        "partsupp": 800_000,
        "nation": 25,
        "region": 5,
    }[name]
    if name in ("nation", "region"):
        return base
    return max(int(base * sf), 1)


def _p_names(rng: np.random.Generator, n: int) -> np.ndarray:
    """Five words of the spec's list per part, drawn in one call (repeats
    allowed, as in the JAX package's generator)."""
    idx = rng.integers(0, len(_P_NAME_WORDS), (n, 5))
    return np.array([" ".join(_P_NAME_WORDS[a] for a in row) for row in idx], object)


def generate_table(name: str, sf: float, seed: int = 19920401) -> Dict[str, np.ndarray]:
    """Deterministic TPC-H-shaped ``lineitem``, ``orders``, ``customer``,
    ``supplier``, ``nation``, ``region``, ``part`` or ``partsupp`` (value
    ranges per the spec; ``p_name`` from the spec's 92 words, 40
    containers). Decimals come pre-scaled as int64 (the engine's physical
    form)."""
    if name not in SCHEMAS:
        raise KeyError(name)
    n = table_rows(name, sf)
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2**31))
    if name == "region":
        return {
            "r_regionkey": np.arange(5, dtype=np.int64),
            "r_name": np.array(_REGIONS, object),
        }
    if name == "nation":
        return {
            "n_nationkey": np.arange(25, dtype=np.int64),
            "n_name": np.array(_NATIONS, object),
            "n_regionkey": np.array(_NATION_REGION, np.int64),
        }
    if name == "customer":
        ck = np.arange(1, n + 1, dtype=np.int64)
        nk = rng.integers(0, 25, n).astype(np.int64)
        return {
            "c_custkey": ck,
            "c_name": np.array([f"Customer#{k:09d}" for k in ck], object),
            "c_nationkey": nk,
            "c_acctbal": rng.integers(-99999, 999999, n).astype(np.int64),
            "c_mktsegment": np.array(_SEGMENTS, object)[rng.integers(0, 5, n)],
            # one rng call per value: the calls set the stream, as in the
            # JAX package's generator
            "c_phone": np.array(
                [f"{10 + k}-{rng.integers(100,999)}-{rng.integers(100,999)}-{rng.integers(1000,9999)}" for k in nk],
                object,
            ),
        }
    if name == "supplier":
        sk = np.arange(1, n + 1, dtype=np.int64)
        complaints = rng.random(n) < 0.01
        return {
            "s_suppkey": sk,
            "s_name": np.array([f"Supplier#{k:09d}" for k in sk], object),
            "s_nationkey": rng.integers(0, 25, n).astype(np.int64),
            "s_acctbal": rng.integers(-99999, 999999, n).astype(np.int64),
            "s_comment": np.array(
                [
                    ("blithely Customer ironic Complaints sleep" if c else "quickly bold deposits nag")
                    for c in complaints
                ],
                object,
            ),
        }
    if name == "part":
        pk = np.arange(1, n + 1, dtype=np.int64)
        types_ = np.array(
            [f"{a} {b} {c}" for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
             for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
             for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")],
            object,
        )
        return {
            "p_partkey": pk,
            "p_name": _p_names(rng, n),
            "p_brand": np.array([f"Brand#{i}{j}" for i, j in zip(rng.integers(1, 6, n),
                                                                 rng.integers(1, 6, n))], object),
            "p_type": types_[rng.integers(0, len(types_), n)],
            "p_size": rng.integers(1, 51, n).astype(np.int32),
            "p_container": np.array(
                [f"{s} {k}" for s in _CONTAINER_SIZES for k in _CONTAINER_KINDS],
                object)[rng.integers(0, 40, n)],
            "p_retailprice": (90000 + pk % 20001).astype(np.int64),
        }
    if name == "partsupp":
        nparts = table_rows("part", sf)
        pk = np.repeat(np.arange(1, nparts + 1, dtype=np.int64), 4)[:n]
        return {
            "ps_partkey": pk,
            "ps_suppkey": rng.integers(1, table_rows("supplier", sf) + 1, n).astype(np.int64),
            "ps_availqty": rng.integers(1, 10000, n).astype(np.int32),
            "ps_supplycost": rng.integers(100, 100001, n).astype(np.int64),
        }
    if name == "orders":
        ok = np.arange(1, n + 1, dtype=np.int64) * 4 - 3  # sparse keys like dbgen
        # custkeys divisible by 3 place no orders (the spec): a dense index
        # over the valid keys 1, 2, 4, 5, 7, 8, ... expanded
        ncust = table_rows("customer", sf)
        m = ncust - ncust // 3
        i = rng.integers(0, m, n)
        custkey = 3 * (i // 2) + 1 + (i % 2)
        return {
            "o_orderkey": ok,
            "o_custkey": custkey.astype(np.int64),
            "o_orderstatus": np.array(["F", "O", "P"], object)[rng.integers(0, 3, n)],
            "o_totalprice": rng.integers(85700, 55558485, n).astype(np.int64),
            "o_orderdate": (_d("1992-01-01") + rng.integers(0, 2406, n)).astype(np.int32),
            "o_orderpriority": np.array(_PRIORITIES, object)[rng.integers(0, 5, n)],
            "o_shippriority": np.zeros(n, np.int32),
        }
    norders = table_rows("orders", sf)
    per = rng.integers(1, 8, norders)
    per = per[: max(1, int(n / per.mean()))]
    okeys = np.repeat(np.arange(1, len(per) + 1, dtype=np.int64) * 4 - 3, per)[:n]
    n = len(okeys)
    linenum = np.concatenate([np.arange(1, c + 1) for c in per])[:n].astype(np.int32)
    qty = rng.integers(1, 51, n).astype(np.int64) * 100  # decimal(15,2)
    price = rng.integers(90000, 10500001, n).astype(np.int64)
    disc = rng.integers(0, 11, n).astype(np.int64)  # 0.00-0.10
    tax = rng.integers(0, 9, n).astype(np.int64)
    ship = (_d("1992-01-02") + rng.integers(0, 2526, n)).astype(np.int32)
    return {
        "l_orderkey": okeys,
        "l_partkey": rng.integers(1, table_rows("part", sf) + 1, n).astype(np.int64),
        "l_suppkey": rng.integers(1, table_rows("supplier", sf) + 1, n).astype(np.int64),
        "l_linenumber": linenum,
        "l_quantity": qty,
        "l_extendedprice": price,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": np.array(["A", "N", "R"], object)[rng.integers(0, 3, n)],
        "l_linestatus": np.array(["F", "O"], object)[rng.integers(0, 2, n)],
        "l_shipdate": ship,
        "l_commitdate": (ship + rng.integers(-30, 31, n)).astype(np.int32),
        "l_receiptdate": (ship + rng.integers(1, 31, n)).astype(np.int32),
        "l_shipmode": np.array(_SHIPMODES, object)[rng.integers(0, 7, n)],
    }


def generate_tables(names, sf: float, seed: int = 19920401) -> Dict[str, Dict[str, np.ndarray]]:
    return {n: generate_table(n, sf, seed) for n in names}


def _date_lit(datestr: str) -> E.Literal:
    return E.lit(_d(datestr), T.DATE)


def q1() -> P.PlanNode:
    """Pricing summary report: filter + 8-aggregate group-by + sort."""
    l = P.Scan("lineitem", SCHEMAS["lineitem"])
    disc_price = E.col("l_extendedprice") * (E.lit(1).cast(_dec(10, 0)) - E.col("l_discount"))
    charge = disc_price * (E.lit(1).cast(_dec(10, 0)) + E.col("l_tax"))
    agg = l.filter(E.col("l_shipdate") <= _date_lit("1998-09-02")).aggregate(
        [E.col("l_returnflag"), E.col("l_linestatus")],
        [
            E.AggExpr("sum", E.col("l_quantity"), "sum_qty"),
            E.AggExpr("sum", E.col("l_extendedprice"), "sum_base_price"),
            E.AggExpr("sum", disc_price, "sum_disc_price"),
            E.AggExpr("sum", charge, "sum_charge"),
            E.AggExpr("avg", E.col("l_quantity"), "avg_qty"),
            E.AggExpr("avg", E.col("l_extendedprice"), "avg_price"),
            E.AggExpr("avg", E.col("l_discount"), "avg_disc"),
            E.AggExpr("count", None, "count_order"),
        ],
    )
    return agg.sort([E.SortOrder(E.col("l_returnflag")), E.SortOrder(E.col("l_linestatus"))])


def q6() -> P.PlanNode:
    """Forecasting revenue change: filter + ungrouped sum."""
    l = P.Scan("lineitem", SCHEMAS["lineitem"])
    pred = (
        (E.col("l_shipdate") >= _date_lit("1994-01-01"))
        & (E.col("l_shipdate") < _date_lit("1995-01-01"))
        & (E.col("l_discount") >= E.lit(0.05, _dec(15, 2)))
        & (E.col("l_discount") <= E.lit(0.07, _dec(15, 2)))
        & (E.col("l_quantity") < E.lit(24, _dec(15, 2)))
    )
    return l.filter(pred).aggregate(
        [], [E.AggExpr("sum", E.col("l_extendedprice") * E.col("l_discount"), "revenue")])


def smj(left: P.PlanNode, right: P.PlanNode, lkeys, rkeys,
        join_type: str = P.JoinType.INNER) -> P.SortMergeJoin:
    """An equi-join in Spark's shape for inputs above the broadcast
    threshold: SortMergeJoin(Sort(ShuffleExchange(left, hash, keys)),
    Sort(ShuffleExchange(right, hash, keys))), each side sorted on its keys
    ascending (Spark's default, nulls first)."""
    def side(p, keys):
        cols = tuple(E.col(k) for k in keys)
        return P.Sort(P.ShuffleExchange(p, "hash", cols), tuple(E.SortOrder(c) for c in cols))

    return P.SortMergeJoin(side(left, lkeys), side(right, rkeys),
                           tuple(E.col(k) for k in lkeys), tuple(E.col(k) for k in rkeys),
                           join_type)


def q3(sort_merge: bool = False) -> P.PlanNode:
    """Shipping priority: 3-way join, group, top-10 by revenue. With
    ``sort_merge``, Spark's plan at scale: both joins SortMergeJoins
    (``smj``) and the top 10 a TakeOrderedAndProject."""
    c = P.Scan("customer", SCHEMAS["customer"]).filter(
        E.col("c_mktsegment") == E.lit("BUILDING")
    )
    o = P.Scan("orders", SCHEMAS["orders"]).filter(
        E.col("o_orderdate") < _date_lit("1995-03-15")
    )
    l = P.Scan("lineitem", SCHEMAS["lineitem"]).filter(
        E.col("l_shipdate") > _date_lit("1995-03-15")
    )
    if sort_merge:
        co = smj(o, c, ("o_custkey",), ("c_custkey",))
        col_ = smj(l, co, ("l_orderkey",), ("o_orderkey",))
    else:
        co = P.HashJoin(o, c, (E.col("o_custkey"),), (E.col("c_custkey"),), P.JoinType.INNER,
                        "right")
        col_ = P.HashJoin(l, co, (E.col("l_orderkey"),), (E.col("o_orderkey"),),
                          P.JoinType.INNER, "right")
    revenue = E.col("l_extendedprice") * (E.lit(1).cast(_dec(10, 0)) - E.col("l_discount"))
    agg = col_.aggregate(
        [E.col("l_orderkey"), E.col("o_orderdate"), E.col("o_shippriority")],
        [E.AggExpr("sum", revenue, "revenue")],
    )
    orders = [E.SortOrder(E.col("revenue"), ascending=False), E.SortOrder(E.col("o_orderdate"))]
    out = [E.col("l_orderkey"), E.col("revenue"), E.col("o_orderdate"), E.col("o_shippriority")]
    if sort_merge:
        return P.TakeOrderedAndProject(agg, tuple(orders), 10, tuple(out))
    return agg.sort(orders, fetch=10).project(out)


def q5() -> P.PlanNode:
    """Local supplier volume: 6-way join, group by nation name."""
    r = P.Scan("region", SCHEMAS["region"]).filter(E.col("r_name") == E.lit("ASIA"))
    n = P.Scan("nation", SCHEMAS["nation"])
    nr = P.HashJoin(n, r, (E.col("n_regionkey"),), (E.col("r_regionkey"),), P.JoinType.INNER, "right")
    s = P.Scan("supplier", SCHEMAS["supplier"])
    sn = P.HashJoin(s, nr, (E.col("s_nationkey"),), (E.col("n_nationkey"),), P.JoinType.INNER, "right")
    c = P.Scan("customer", SCHEMAS["customer"])
    o = P.Scan("orders", SCHEMAS["orders"]).filter(
        (E.col("o_orderdate") >= _date_lit("1994-01-01"))
        & (E.col("o_orderdate") < _date_lit("1995-01-01"))
    )
    l = P.Scan("lineitem", SCHEMAS["lineitem"])
    lo = P.HashJoin(l, o, (E.col("l_orderkey"),), (E.col("o_orderkey"),), P.JoinType.INNER, "right")
    loc = P.HashJoin(
        lo, c, (E.col("o_custkey"),), (E.col("c_custkey"),), P.JoinType.INNER, "right"
    )
    # join on (l_suppkey = s_suppkey AND c_nationkey = s_nationkey)
    locs = P.HashJoin(
        loc,
        sn,
        (E.col("l_suppkey"), E.col("c_nationkey")),
        (E.col("s_suppkey"), E.col("s_nationkey")),
        P.JoinType.INNER,
        "right",
    )
    revenue = E.col("l_extendedprice") * (E.lit(1).cast(_dec(10, 0)) - E.col("l_discount"))
    agg = locs.aggregate([E.col("n_name")], [E.AggExpr("sum", revenue, "revenue")])
    return agg.sort([E.SortOrder(E.col("revenue"), ascending=False)])


def q4() -> P.PlanNode:
    """Order priority checking: EXISTS -> left-semi join + group-by."""
    o = P.Scan("orders", SCHEMAS["orders"]).filter(
        (E.col("o_orderdate") >= _date_lit("1993-07-01"))
        & (E.col("o_orderdate") < _date_lit("1993-10-01"))
    )
    l = P.Scan("lineitem", SCHEMAS["lineitem"]).filter(
        E.col("l_commitdate") < E.col("l_receiptdate")
    )
    semi = P.HashJoin(
        o, l, (E.col("o_orderkey"),), (E.col("l_orderkey"),), P.JoinType.LEFT_SEMI, "right"
    )
    agg = semi.aggregate([E.col("o_orderpriority")], [E.AggExpr("count", None, "order_count")])
    return agg.sort([E.SortOrder(E.col("o_orderpriority"))])


def q15() -> P.PlanNode:
    """Top supplier: revenue view + join on max revenue."""
    l = P.Scan("lineitem", SCHEMAS["lineitem"]).filter(
        (E.col("l_shipdate") >= _date_lit("1996-01-01"))
        & (E.col("l_shipdate") < _date_lit("1996-04-01"))
    )
    rev = E.col("l_extendedprice") * (E.lit(1).cast(_dec(10, 0)) - E.col("l_discount"))
    revenue = l.aggregate([E.col("l_suppkey")], [E.AggExpr("sum", rev, "total_revenue")])
    maxrev = revenue.aggregate([], [E.AggExpr("max", E.col("total_revenue"), "max_revenue")])
    top = P.HashJoin(
        revenue, maxrev, (E.col("total_revenue"),), (E.col("max_revenue"),),
        P.JoinType.LEFT_SEMI, "right",
    )
    s = P.Scan("supplier", SCHEMAS["supplier"])
    j = P.HashJoin(s, top, (E.col("s_suppkey"),), (E.col("l_suppkey"),), P.JoinType.INNER, "right")
    return j.sort([E.SortOrder(E.col("s_suppkey"))]).project(
        [E.col("s_suppkey"), E.col("s_name"), E.col("total_revenue")]
    )


def q12(sort_merge: bool = False) -> P.PlanNode:
    """Shipping modes and order priority: join + conditional counts. With
    ``sort_merge``, the join is Spark's SortMergeJoin shape (``smj``)."""
    o = P.Scan("orders", SCHEMAS["orders"])
    l = P.Scan("lineitem", SCHEMAS["lineitem"]).filter(
        (E.col("l_shipmode").isin("MAIL", "SHIP"))
        & (E.col("l_commitdate") < E.col("l_receiptdate"))
        & (E.col("l_shipdate") < E.col("l_commitdate"))
        & (E.col("l_receiptdate") >= _date_lit("1994-01-01"))
        & (E.col("l_receiptdate") < _date_lit("1995-01-01"))
    )
    j = (smj(l, o, ("l_orderkey",), ("o_orderkey",)) if sort_merge else
         P.HashJoin(l, o, (E.col("l_orderkey"),), (E.col("o_orderkey"),), P.JoinType.INNER,
                    "right"))
    urgent = (E.col("o_orderpriority") == E.lit("1-URGENT")) | (
        E.col("o_orderpriority") == E.lit("2-HIGH"))
    other = (E.col("o_orderpriority") != E.lit("1-URGENT")) & (
        E.col("o_orderpriority") != E.lit("2-HIGH"))
    high = E.CaseWhen(((urgent, E.lit(1)),), E.lit(0))
    low = E.CaseWhen(((other, E.lit(1)),), E.lit(0))
    agg = j.aggregate(
        [E.col("l_shipmode")],
        [E.AggExpr("sum", high, "high_line_count"), E.AggExpr("sum", low, "low_line_count")],
    )
    return agg.sort([E.SortOrder(E.col("l_shipmode"))])


def q10() -> P.PlanNode:
    """Returned item reporting: top-20 customers by lost revenue."""
    c = P.Scan("customer", SCHEMAS["customer"])
    o = P.Scan("orders", SCHEMAS["orders"]).filter(
        (E.col("o_orderdate") >= _date_lit("1993-10-01"))
        & (E.col("o_orderdate") < _date_lit("1994-01-01"))
    )
    l = P.Scan("lineitem", SCHEMAS["lineitem"]).filter(E.col("l_returnflag") == E.lit("R"))
    n = P.Scan("nation", SCHEMAS["nation"])
    lo = P.HashJoin(l, o, (E.col("l_orderkey"),), (E.col("o_orderkey"),), P.JoinType.INNER, "right")
    loc = P.HashJoin(lo, c, (E.col("o_custkey"),), (E.col("c_custkey"),), P.JoinType.INNER, "right")
    locn = P.HashJoin(loc, n, (E.col("c_nationkey"),), (E.col("n_nationkey"),), P.JoinType.INNER,
                      "right")
    revenue = E.col("l_extendedprice") * (E.lit(1).cast(_dec(10, 0)) - E.col("l_discount"))
    agg = locn.aggregate(
        [E.col("c_custkey"), E.col("c_name"), E.col("c_acctbal"), E.col("n_name")],
        [E.AggExpr("sum", revenue, "revenue")],
    )
    return agg.sort([E.SortOrder(E.col("revenue"), ascending=False)], fetch=20)


def q18(min_qty: int = 300) -> P.PlanNode:
    """Large volume customers: orders whose lineitem quantity sum exceeds
    ``min_qty`` (300 in TPC-H), top 100 by price then date."""
    l = P.Scan("lineitem", SCHEMAS["lineitem"])
    perorder = l.aggregate([E.col("l_orderkey")], [E.AggExpr("sum", E.col("l_quantity"), "qty")])
    big = P.Filter(perorder, E.col("qty") > E.lit(min_qty, _dec(25, 2)))
    o = P.Scan("orders", SCHEMAS["orders"])
    ob = P.HashJoin(o, big, (E.col("o_orderkey"),), (E.col("l_orderkey"),), P.JoinType.LEFT_SEMI,
                    "right")
    c = P.Scan("customer", SCHEMAS["customer"])
    oc = P.HashJoin(ob, c, (E.col("o_custkey"),), (E.col("c_custkey"),), P.JoinType.INNER, "right")
    l2 = P.Scan("lineitem", SCHEMAS["lineitem"])
    j = P.HashJoin(l2, oc, (E.col("l_orderkey"),), (E.col("o_orderkey"),), P.JoinType.INNER,
                   "right")
    agg = j.aggregate(
        [E.col("c_name"), E.col("c_custkey"), E.col("o_orderkey"), E.col("o_orderdate"),
         E.col("o_totalprice")],
        [E.AggExpr("sum", E.col("l_quantity"), "sum_qty")],
    )
    return agg.sort(
        [E.SortOrder(E.col("o_totalprice"), ascending=False), E.SortOrder(E.col("o_orderdate"))],
        fetch=100,
    )


def q19() -> P.PlanNode:
    """Discounted revenue: lineitem joined to part under a disjunction of
    three brand, container, quantity and size clauses, one ungrouped sum."""
    l = P.Scan("lineitem", SCHEMAS["lineitem"]).filter(
        E.col("l_shipmode").isin("AIR", "REG AIR"))
    p = P.Scan("part", SCHEMAS["part"])
    j = P.HashJoin(l, p, (E.col("l_partkey"),), (E.col("p_partkey"),), P.JoinType.INNER, "right")

    def clause(brand, containers, qlo, qhi, szhi):
        return ((E.col("p_brand") == E.lit(brand))
                & E.col("p_container").isin(*containers)
                & (E.col("l_quantity") >= E.lit(qlo, _dec(15, 2)))
                & (E.col("l_quantity") <= E.lit(qhi, _dec(15, 2)))
                & (E.col("p_size").between(1, szhi)))

    pred = (clause("Brand#12", ["SM CASE"], 1, 11, 5)
            | clause("Brand#23", ["MED BAG"], 10, 20, 10)
            | clause("Brand#34", ["LG BOX"], 20, 30, 15))
    disc = E.col("l_extendedprice") * (E.lit(1).cast(_dec(10, 0)) - E.col("l_discount"))
    return j.filter(pred).aggregate([], [E.AggExpr("sum", disc, "revenue")])


def q2() -> P.PlanNode:
    """Minimum cost supplier: the correlated MIN subquery as a per-part MIN
    over the EUROPE suppliers' partsupp rows, joined back on (part, cost) by
    a LEFT_SEMI join; the parts of size 15 whose type ends in BRASS; top 100
    by supplier balance. ``pss`` feeds both the MIN and the join."""
    p = P.Scan("part", SCHEMAS["part"]).filter(
        (E.col("p_size") == E.lit(15)) & E.col("p_type").like("%BRASS"))
    r = P.Scan("region", SCHEMAS["region"]).filter(E.col("r_name") == E.lit("EUROPE"))
    n = P.Scan("nation", SCHEMAS["nation"])
    nr = P.HashJoin(n, r, (E.col("n_regionkey"),), (E.col("r_regionkey"),), P.JoinType.INNER,
                    "right")
    s = P.Scan("supplier", SCHEMAS["supplier"])
    sn = P.HashJoin(s, nr, (E.col("s_nationkey"),), (E.col("n_nationkey"),), P.JoinType.INNER,
                    "right")
    ps = P.Scan("partsupp", SCHEMAS["partsupp"])
    pss = P.HashJoin(ps, sn, (E.col("ps_suppkey"),), (E.col("s_suppkey"),), P.JoinType.INNER,
                     "right")
    mincost = P.HashAggregate(
        pss, (E.col("ps_partkey"),), (E.AggExpr("min", E.col("ps_supplycost"), "min_cost"),),
        P.AggMode.SINGLE)
    psp = P.HashJoin(pss, p, (E.col("ps_partkey"),), (E.col("p_partkey"),), P.JoinType.INNER,
                     "right")
    best = P.HashJoin(psp, mincost, (E.col("ps_partkey"), E.col("ps_supplycost")),
                      (E.col("ps_partkey"), E.col("min_cost")), P.JoinType.LEFT_SEMI, "right")
    # the schema has no p_mfgr: the JAX plan projects p_brand in its place
    return best.sort(
        [E.SortOrder(E.col("s_acctbal"), ascending=False), E.SortOrder(E.col("n_name")),
         E.SortOrder(E.col("s_name")), E.SortOrder(E.col("p_partkey"))],
        fetch=100,
    ).project([E.col("s_acctbal"), E.col("s_name"), E.col("n_name"), E.col("p_partkey"),
               E.col("p_brand")])


def q9() -> P.PlanNode:
    """Product type profit by nation and year: the parts whose name holds
    'green', five INNER joins (one on the two keys of partsupp), profit
    summed per nation and order year."""
    p = P.Scan("part", SCHEMAS["part"]).filter(E.col("p_name").like("%green%"))
    l = P.Scan("lineitem", SCHEMAS["lineitem"])
    lp = P.HashJoin(l, p, (E.col("l_partkey"),), (E.col("p_partkey"),), P.JoinType.INNER, "right")
    ps = P.Scan("partsupp", SCHEMAS["partsupp"])
    lps = P.HashJoin(lp, ps, (E.col("l_suppkey"), E.col("l_partkey")),
                     (E.col("ps_suppkey"), E.col("ps_partkey")), P.JoinType.INNER, "right")
    s = P.Scan("supplier", SCHEMAS["supplier"])
    lpss = P.HashJoin(lps, s, (E.col("l_suppkey"),), (E.col("s_suppkey"),), P.JoinType.INNER,
                      "right")
    o = P.Scan("orders", SCHEMAS["orders"])
    lpsso = P.HashJoin(lpss, o, (E.col("l_orderkey"),), (E.col("o_orderkey"),),
                       P.JoinType.INNER, "right")
    n = P.Scan("nation", SCHEMAS["nation"])
    j = P.HashJoin(lpsso, n, (E.col("s_nationkey"),), (E.col("n_nationkey"),), P.JoinType.INNER,
                   "right")
    amount = (E.col("l_extendedprice") * (E.lit(1).cast(_dec(10, 0)) - E.col("l_discount"))
              - (E.col("ps_supplycost") * E.col("l_quantity")).cast(_dec(38, 4)))
    pre = j.project([E.col("n_name").alias("nation"),
                     E.TemporalFunc("year", (E.col("o_orderdate"),)).alias("o_year"),
                     amount.alias("amount")])
    agg = pre.aggregate([E.col("nation"), E.col("o_year")],
                        [E.AggExpr("sum", E.col("amount"), "sum_profit")])
    return agg.sort([E.SortOrder(E.col("nation")), E.SortOrder(E.col("o_year"), ascending=False)])


def q7() -> P.PlanNode:
    """Volume shipping: the FRANCE-GERMANY trade in either direction,
    revenue per supplier nation, customer nation and ship year."""
    n1 = P.Scan("nation", SCHEMAS["nation"]).project(
        [E.col("n_nationkey").alias("n1_key"), E.col("n_name").alias("supp_nation")]
    ).filter((E.col("supp_nation") == E.lit("FRANCE"))
             | (E.col("supp_nation") == E.lit("GERMANY")))
    n2 = P.Scan("nation", SCHEMAS["nation"]).project(
        [E.col("n_nationkey").alias("n2_key"), E.col("n_name").alias("cust_nation")]
    ).filter((E.col("cust_nation") == E.lit("FRANCE"))
             | (E.col("cust_nation") == E.lit("GERMANY")))
    l = P.Scan("lineitem", SCHEMAS["lineitem"]).filter(
        (E.col("l_shipdate") >= _date_lit("1995-01-01"))
        & (E.col("l_shipdate") <= _date_lit("1996-12-31")))
    s = P.Scan("supplier", SCHEMAS["supplier"])
    o = P.Scan("orders", SCHEMAS["orders"])
    c = P.Scan("customer", SCHEMAS["customer"])
    ls = P.HashJoin(l, s, (E.col("l_suppkey"),), (E.col("s_suppkey"),), P.JoinType.INNER, "right")
    lso = P.HashJoin(ls, o, (E.col("l_orderkey"),), (E.col("o_orderkey"),), P.JoinType.INNER,
                     "right")
    lsoc = P.HashJoin(lso, c, (E.col("o_custkey"),), (E.col("c_custkey"),), P.JoinType.INNER,
                      "right")
    j1 = P.HashJoin(lsoc, n1, (E.col("s_nationkey"),), (E.col("n1_key"),), P.JoinType.INNER,
                    "right")
    j2 = P.HashJoin(j1, n2, (E.col("c_nationkey"),), (E.col("n2_key"),), P.JoinType.INNER,
                    "right")
    cross = j2.filter(
        ((E.col("supp_nation") == E.lit("FRANCE")) & (E.col("cust_nation") == E.lit("GERMANY")))
        | ((E.col("supp_nation") == E.lit("GERMANY")) & (E.col("cust_nation") == E.lit("FRANCE"))))
    vol = E.col("l_extendedprice") * (E.lit(1).cast(_dec(10, 0)) - E.col("l_discount"))
    withyear = cross.project(
        [E.col("supp_nation"), E.col("cust_nation"),
         E.TemporalFunc("year", (E.col("l_shipdate"),)).alias("l_year"), vol.alias("volume")])
    agg = withyear.aggregate(
        [E.col("supp_nation"), E.col("cust_nation"), E.col("l_year")],
        [E.AggExpr("sum", E.col("volume"), "revenue")])
    return agg.sort([E.SortOrder(E.col("supp_nation")), E.SortOrder(E.col("cust_nation")),
                     E.SortOrder(E.col("l_year"))])


def q8() -> P.PlanNode:
    """National market share: BRAZIL's share, per order year, of the
    AMERICA region's ECONOMY ANODIZED STEEL volume; the volume is a DOUBLE,
    summed per year, and the share a float division."""
    p = P.Scan("part", SCHEMAS["part"]).filter(E.col("p_type") == E.lit("ECONOMY ANODIZED STEEL"))
    l = P.Scan("lineitem", SCHEMAS["lineitem"])
    lp = P.HashJoin(l, p, (E.col("l_partkey"),), (E.col("p_partkey"),), P.JoinType.INNER, "right")
    o = P.Scan("orders", SCHEMAS["orders"]).filter(
        (E.col("o_orderdate") >= _date_lit("1995-01-01"))
        & (E.col("o_orderdate") <= _date_lit("1996-12-31")))
    lpo = P.HashJoin(lp, o, (E.col("l_orderkey"),), (E.col("o_orderkey"),), P.JoinType.INNER,
                     "right")
    c = P.Scan("customer", SCHEMAS["customer"])
    lpoc = P.HashJoin(lpo, c, (E.col("o_custkey"),), (E.col("c_custkey"),), P.JoinType.INNER,
                      "right")
    n1 = P.Scan("nation", SCHEMAS["nation"]).project(
        [E.col("n_nationkey").alias("n1_key"), E.col("n_regionkey").alias("n1_region")])
    r = P.Scan("region", SCHEMAS["region"]).filter(E.col("r_name") == E.lit("AMERICA"))
    n1r = P.HashJoin(n1, r, (E.col("n1_region"),), (E.col("r_regionkey"),), P.JoinType.INNER,
                     "right")
    j1 = P.HashJoin(lpoc, n1r, (E.col("c_nationkey"),), (E.col("n1_key"),), P.JoinType.INNER,
                    "right")
    s = P.Scan("supplier", SCHEMAS["supplier"])
    j2 = P.HashJoin(j1, s, (E.col("l_suppkey"),), (E.col("s_suppkey"),), P.JoinType.INNER, "right")
    n2 = P.Scan("nation", SCHEMAS["nation"]).project(
        [E.col("n_nationkey").alias("n2_key"), E.col("n_name").alias("supp_nation")])
    j3 = P.HashJoin(j2, n2, (E.col("s_nationkey"),), (E.col("n2_key"),), P.JoinType.INNER,
                    "right")
    vol = (E.col("l_extendedprice")
           * (E.lit(1).cast(_dec(10, 0)) - E.col("l_discount"))).cast(T.FLOAT64)
    pre = j3.project(
        [E.TemporalFunc("year", (E.col("o_orderdate"),)).alias("o_year"),
         vol.alias("volume"),
         E.CaseWhen(((E.col("supp_nation") == E.lit("BRAZIL"), vol),),
                    E.lit(0.0)).alias("brazil_vol")])
    agg = pre.aggregate(
        [E.col("o_year")],
        [E.AggExpr("sum", E.col("brazil_vol"), "bv"), E.AggExpr("sum", E.col("volume"), "tv")])
    share = P.Projection(agg, (E.col("o_year"), (E.col("bv") / E.col("tv")).alias("mkt_share")))
    return P.Sort(share, (E.SortOrder(E.col("o_year")),))


def q11(fraction: float = 0.0001) -> P.PlanNode:
    """Important stock: GERMANY's partsupp value per part, kept where it is
    over ``fraction`` of the total; the total is one row, joined to every
    part by a broadcast nested-loop join with the DOUBLE comparison as
    condition. TPC-H's FRACTION is 0.0001 / SF; the default is SF1's (the
    JAX plan's constant), under which no part qualifies from SF10 up."""
    n = P.Scan("nation", SCHEMAS["nation"]).filter(E.col("n_name") == E.lit("GERMANY"))
    s = P.Scan("supplier", SCHEMAS["supplier"])
    sn = P.HashJoin(s, n, (E.col("s_nationkey"),), (E.col("n_nationkey"),), P.JoinType.INNER,
                    "right")
    ps = P.Scan("partsupp", SCHEMAS["partsupp"])
    pss = P.HashJoin(ps, sn, (E.col("ps_suppkey"),), (E.col("s_suppkey"),), P.JoinType.INNER,
                     "right")
    value = (E.col("ps_supplycost") * E.col("ps_availqty").cast(T.INT64)).alias("value")
    per_part = pss.aggregate([E.col("ps_partkey")], [E.AggExpr("sum", value, "value")])
    total = pss.aggregate([], [E.AggExpr("sum", value, "total")])
    thresh = P.Projection(
        total, ((E.col("total").cast(T.FLOAT64) * E.lit(float(fraction))).alias("threshold"),))
    j = P.BroadcastNestedLoopJoin(
        per_part, thresh, P.JoinType.INNER,
        condition=E.col("value").cast(T.FLOAT64) > E.col("threshold"))
    return P.Sort(P.Projection(j, (E.col("ps_partkey"), E.col("value"))),
                  (E.SortOrder(E.col("value"), ascending=False),))


def q14() -> P.PlanNode:
    """Promotion effect: the share of September 1995's revenue from PROMO
    parts, the two decimal sums cast to DOUBLE and divided."""
    l = P.Scan("lineitem", SCHEMAS["lineitem"]).filter(
        (E.col("l_shipdate") >= _date_lit("1995-09-01"))
        & (E.col("l_shipdate") < _date_lit("1995-10-01")))
    p = P.Scan("part", SCHEMAS["part"])
    j = P.HashJoin(l, p, (E.col("l_partkey"),), (E.col("p_partkey"),), P.JoinType.INNER, "right")
    disc = E.col("l_extendedprice") * (E.lit(1).cast(_dec(10, 0)) - E.col("l_discount"))
    promo = E.CaseWhen(((E.col("p_type").like("PROMO%"), disc),), None)
    agg = j.aggregate(
        [], [E.AggExpr("sum", promo, "promo_rev"), E.AggExpr("sum", disc, "total_rev")])
    return P.Projection(
        agg, ((E.lit(100.0) * E.col("promo_rev").cast(T.FLOAT64)
               / E.col("total_rev").cast(T.FLOAT64)).alias("promo_revenue"),))


def q17() -> P.PlanNode:
    """Small-quantity-order revenue: the correlated AVG as a per-part
    average over all of lineitem, joined back under the DOUBLE condition
    quantity < 0.2 x average; the yearly average of the kept revenue."""
    p = P.Scan("part", SCHEMAS["part"]).filter(
        (E.col("p_brand") == E.lit("Brand#23")) & (E.col("p_container") == E.lit("MED BAG")))
    l = P.Scan("lineitem", SCHEMAS["lineitem"])
    avgq = l.aggregate([E.col("l_partkey")], [E.AggExpr("avg", E.col("l_quantity"), "avg_qty")])
    lp = P.HashJoin(l, p, (E.col("l_partkey"),), (E.col("p_partkey"),), P.JoinType.INNER, "right")
    j = P.HashJoin(
        lp, avgq, (E.col("l_partkey"),), (E.col("l_partkey"),), P.JoinType.INNER, "right",
        condition=E.col("l_quantity").cast(T.FLOAT64)
        < E.lit(0.2) * E.col("avg_qty").cast(T.FLOAT64))
    agg = j.aggregate([], [E.AggExpr("sum", E.col("l_extendedprice"), "s")])
    return P.Projection(agg, ((E.col("s").cast(T.FLOAT64) / E.lit(7.0)).alias("avg_yearly"),))


def q13() -> P.PlanNode:
    """Customer distribution: customer LEFT JOIN orders (probe customer, so
    a customer with no order comes out once with a null order side), the
    orders per customer (COUNT of o_orderkey counts matched rows only), then
    the customers per order count. The JAX package's orders table has no
    o_comment, so its NOT LIKE '%special%requests%' reads o_orderpriority
    and keeps every order (ROADMAP C15); this plan is the same."""
    c = P.Scan("customer", SCHEMAS["customer"])
    o = P.Scan("orders", SCHEMAS["orders"]).filter(
        E.Like(E.col("o_orderpriority"), "%special%requests%", negated=True))
    j = P.HashJoin(c, o, (E.col("c_custkey"),), (E.col("o_custkey"),), P.JoinType.LEFT, "right")
    per_cust = j.aggregate([E.col("c_custkey")],
                           [E.AggExpr("count", E.col("o_orderkey"), "c_count")])
    dist = per_cust.aggregate([E.col("c_count")], [E.AggExpr("count", None, "custdist")])
    return dist.sort([E.SortOrder(E.col("custdist"), ascending=False),
                      E.SortOrder(E.col("c_count"), ascending=False)])


def q16(null_aware: bool = False) -> P.PlanNode:
    """Parts/supplier relationship: partsupp joined to the parts that pass
    three filters, the suppliers with complaints removed by a LEFT ANTI
    join (s_suppkey is never null, so NOT IN needs no null-aware join; the
    JAX package plans it so), and COUNT(DISTINCT ps_suppkey) per brand, type
    and size. With ``null_aware``, the NOT IN is Spark's plan of it, a
    LEFT_ANTI_NULL_AWARE join: the same rows."""
    p = P.Scan("part", SCHEMAS["part"]).filter(
        (E.col("p_brand") != E.lit("Brand#45"))
        & E.Like(E.col("p_type"), "MEDIUM POLISHED%", negated=True)
        & E.col("p_size").isin(49, 14, 23, 45, 19, 3, 36, 9))
    ps = P.Scan("partsupp", SCHEMAS["partsupp"])
    psp = P.HashJoin(ps, p, (E.col("ps_partkey"),), (E.col("p_partkey"),), P.JoinType.INNER,
                     "right")
    bad = P.Scan("supplier", SCHEMAS["supplier"]).filter(
        E.col("s_comment").like("%Customer%Complaints%")).project([E.col("s_suppkey")])
    good = P.HashJoin(psp, bad, (E.col("ps_suppkey"),), (E.col("s_suppkey"),),
                      P.JoinType.LEFT_ANTI_NULL_AWARE if null_aware else P.JoinType.LEFT_ANTI,
                      "right")
    agg = good.aggregate([E.col("p_brand"), E.col("p_type"), E.col("p_size")],
                         [E.AggExpr("count_distinct", E.col("ps_suppkey"), "supplier_cnt")])
    return agg.sort([E.SortOrder(E.col("supplier_cnt"), ascending=False),
                     E.SortOrder(E.col("p_brand")), E.SortOrder(E.col("p_type")),
                     E.SortOrder(E.col("p_size"))])


def q20(pattern: str = "forest%", ship_from: str = "1994-01-01",
        ship_to: str = "1995-01-01") -> P.PlanNode:
    """Potential part promotion: CANADA's suppliers whose available quantity
    of a part named ``pattern`` is over half of what they shipped of it in
    [``ship_from``, ``ship_to``) (the correlated subqueries as a per-(part,
    supplier) SUM joined on both keys under a DOUBLE condition). TPC-H's
    literals are the defaults; the generator draws l_suppkey and ps_suppkey
    independently, so few lineitems find their partsupp row and the answer
    is empty at those literals (ROADMAP C16): pattern "%" over 1992-1998
    keeps rows."""
    p = P.Scan("part", SCHEMAS["part"]).filter(E.col("p_name").like(pattern)).project(
        [E.col("p_partkey")])
    l = P.Scan("lineitem", SCHEMAS["lineitem"]).filter(
        (E.col("l_shipdate") >= _date_lit(ship_from)) & (E.col("l_shipdate") < _date_lit(ship_to)))
    shipped = l.aggregate([E.col("l_partkey"), E.col("l_suppkey")],
                          [E.AggExpr("sum", E.col("l_quantity"), "qty")])
    ps = P.Scan("partsupp", SCHEMAS["partsupp"])
    ps_part = P.HashJoin(ps, p, (E.col("ps_partkey"),), (E.col("p_partkey"),),
                         P.JoinType.LEFT_SEMI, "right")
    psq = P.HashJoin(
        ps_part, shipped, (E.col("ps_partkey"), E.col("ps_suppkey")),
        (E.col("l_partkey"), E.col("l_suppkey")), P.JoinType.INNER, "right",
        condition=E.col("ps_availqty").cast(T.INT64).cast(T.FLOAT64)
        > E.lit(0.005) * E.col("qty").cast(T.FLOAT64))  # qty is scale 2: 0.5 / 100
    supp_keys = P.Projection(psq, (E.col("ps_suppkey"),))
    n = P.Scan("nation", SCHEMAS["nation"]).filter(E.col("n_name") == E.lit("CANADA"))
    s = P.Scan("supplier", SCHEMAS["supplier"])
    sn = P.HashJoin(s, n, (E.col("s_nationkey"),), (E.col("n_nationkey"),), P.JoinType.INNER,
                    "right")
    out = P.HashJoin(sn, supp_keys, (E.col("s_suppkey"),), (E.col("ps_suppkey"),),
                     P.JoinType.LEFT_SEMI, "right")
    return P.Sort(P.Projection(out, (E.col("s_name"), E.col("s_suppkey"))),
                  (E.SortOrder(E.col("s_name")),))


def q21() -> P.PlanNode:
    """Suppliers who kept orders waiting: multi-exists/not-exists with
    inequality correlation (semi/anti joins with extra conditions)."""
    n = P.Scan("nation", SCHEMAS["nation"]).filter(E.col("n_name") == E.lit("SAUDI ARABIA"))
    s = P.Scan("supplier", SCHEMAS["supplier"])
    sn = P.HashJoin(s, n, (E.col("s_nationkey"),), (E.col("n_nationkey"),), P.JoinType.INNER, "right")
    l1 = P.Scan("lineitem", SCHEMAS["lineitem"]).filter(
        E.col("l_receiptdate") > E.col("l_commitdate")
    )
    o = P.Scan("orders", SCHEMAS["orders"]).filter(E.col("o_orderstatus") == E.lit("F"))
    l1o = P.HashJoin(l1, o, (E.col("l_orderkey"),), (E.col("o_orderkey"),), P.JoinType.LEFT_SEMI, "right")
    l1s = P.HashJoin(l1o, sn, (E.col("l_suppkey"),), (E.col("s_suppkey"),), P.JoinType.INNER, "right")
    # exists other-supplier lineitem on same order
    l2 = P.Scan("lineitem", SCHEMAS["lineitem"]).project(
        [E.col("l_orderkey").alias("lo2"), E.col("l_suppkey").alias("ls2")]
    )
    with_l2 = P.HashJoin(
        l1s, l2, (E.col("l_orderkey"),), (E.col("lo2"),), P.JoinType.LEFT_SEMI, "right",
        condition=E.col("ls2") != E.col("l_suppkey"),
    )
    # not exists other-supplier LATE lineitem on same order
    l3 = P.Scan("lineitem", SCHEMAS["lineitem"]).filter(
        E.col("l_receiptdate") > E.col("l_commitdate")
    ).project([E.col("l_orderkey").alias("lo3"), E.col("l_suppkey").alias("ls3")])
    without_l3 = P.HashJoin(
        with_l2, l3, (E.col("l_orderkey"),), (E.col("lo3"),), P.JoinType.LEFT_ANTI, "right",
        condition=E.col("ls3") != E.col("l_suppkey"),
    )
    agg = without_l3.aggregate([E.col("s_name")], [E.AggExpr("count", None, "numwait")])
    return agg.sort(
        [E.SortOrder(E.col("numwait"), ascending=False), E.SortOrder(E.col("s_name"))],
        fetch=100,
    )


def q22() -> P.PlanNode:
    """Global sales opportunity: country-code substring, acctbal above the
    positive average (nested-loop vs the global avg), no orders (anti join)."""
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    c = P.Scan("customer", SCHEMAS["customer"]).project(
        [E.col("c_custkey"), E.col("c_acctbal"),
         E.StringFunc("substring", (E.col("c_phone"), E.lit(1), E.lit(2))).alias("cntrycode")]
    ).filter(E.col("cntrycode").isin(*codes))
    avg_bal = P.Scan("customer", SCHEMAS["customer"]).project(
        [E.col("c_acctbal"),
         E.StringFunc("substring", (E.col("c_phone"), E.lit(1), E.lit(2))).alias("cc")]
    ).filter(
        (E.col("c_acctbal") > E.lit(0, _dec(15, 2))) & E.col("cc").isin(*codes)
    ).aggregate([], [E.AggExpr("avg", E.col("c_acctbal"), "ab")])
    rich = P.BroadcastNestedLoopJoin(
        c, avg_bal, P.JoinType.INNER,
        condition=E.col("c_acctbal").cast(T.FLOAT64) > E.col("ab").cast(T.FLOAT64),
    )
    o = P.Scan("orders", SCHEMAS["orders"]).project([E.col("o_custkey")])
    noord = P.HashJoin(rich, o, (E.col("c_custkey"),), (E.col("o_custkey"),), P.JoinType.LEFT_ANTI, "right")
    agg = noord.aggregate(
        [E.col("cntrycode")],
        [E.AggExpr("count", None, "numcust"), E.AggExpr("sum", E.col("c_acctbal"), "totacctbal")],
    )
    return agg.sort([E.SortOrder(E.col("cntrycode"))])


# every query of the port, by name
QUERIES = {"q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q7": q7, "q8": q8,
           "q9": q9, "q10": q10, "q11": q11, "q12": q12, "q13": q13, "q14": q14, "q15": q15,
           "q16": q16, "q17": q17, "q18": q18, "q19": q19, "q20": q20, "q21": q21, "q22": q22}
