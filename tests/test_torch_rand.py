"""PyTorch port, the nondeterministic expressions and Sample
(exec/random_xorshift.py, ``operators/basic.py::sample_op``): rand equals
the JAX package's XORShiftRandom scan bit for bit and randn within
``RANDN_RTOL`` (torch's log and sqrt against XLA's, a few ulps), row for
row on batches with dead rows (a row's draw is its live rank: the order
before them is the scan's, so rows compare in place); the jump-ahead
against the plain step; monotonically_increasing_id and
spark_partition_id in a partition; Sample without replacement the JAX
package's rows exactly, with replacement Poisson counts (torch's
generator, not the JAX PRNG: ROADMAP C28) held to the distribution; every
plan walk takes a Sample as the JAX package does; the host filter and the
runtime filters leave rand() alone."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_expr import stage
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from datafusion_comet_tpu.exec import random_xorshift as JRX
from datafusion_comet_tpu.exec.operators import basic as JBO
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.exec import host_filter as HF
from datafusion_comet_tpu_torch.exec import random_xorshift as PRX
from datafusion_comet_tpu_torch.exec import runtime_filter as RF
from datafusion_comet_tpu_torch.exec.engine import Session, find_stream_agg
from datafusion_comet_tpu_torch.exec.operators import basic as PBO
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.ir import serde

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RANDN_RTOL = 1e-13
N = 700
MASK = np.random.default_rng(2).random(N) < 0.8


@pytest.mark.parametrize("seed,partition", [(0, 0), (42, 3), (-7, 1)])
def test_rand_randn_equal_jax(seed, partition):
    s0 = PRX.init_seed_host(seed, partition)
    assert s0 == JRX.init_seed_host(seed, partition)
    jm, pm = jnp.asarray(MASK), torch.from_numpy(MASK)
    np.testing.assert_array_equal(PRX.rand_column(s0, pm).data.numpy(),
                                  np.asarray(JRX.rand_column(s0, jm).data))
    np.testing.assert_allclose(PRX.randn_column(s0, pm).data.numpy(),
                               np.asarray(JRX.randn_column(s0, jm).data), rtol=RANDN_RTOL,
                               atol=0)


def test_jump_ahead_equals_the_step():
    """M^n by the byte tables against n plain steps, n up to 2^12 + 5."""
    s0 = PRX.init_seed_host(5)
    n = torch.tensor([0, 1, 2, 3, 7, 64, 1000, 4101])
    got = PRX.jump(s0, n, 4101)
    x, want = torch.tensor([s0]), {}
    for k in range(4102):
        want[k] = x.item()
        x = PRX.xorshift_step(x)
    assert got.tolist() == [want[int(k)] for k in n]


def test_expressions_in_a_partition_equal_jax():
    """rand, randn, monotonically_increasing_id and spark_partition_id
    through both evaluators with a partition id and a row offset."""
    from datafusion_comet_tpu.exec import evaluator as JEV
    from datafusion_comet_tpu.ir import expr as JE

    jb, pb = stage([("x", lambda T: T.INT32)], {"x": np.arange(N, dtype=np.int32)}, mask=MASK)
    for build in (lambda E: E.RandExpr("rand", 9), lambda E: E.RandExpr("randn", 9),
                  lambda E: E.MonotonicallyIncreasingId(), lambda E: E.SparkPartitionId()):
        je, pe = JE.bind(build(JE), jb.schema), PE.bind(build(PE), pb.schema)
        assert repr(je.dtype) == repr(pe.dtype)
        j = JEV.evaluate(je, jb, JEV.EvalContext(partition_id=2, num_partitions=4,
                                                 batch_row_offset=100))
        p = PEV.evaluate(pe, pb, PEV.EvalContext(partition_id=2, num_partitions=4,
                                                 batch_row_offset=100))
        live = np.asarray(jb.row_mask)
        if pe.dtype == PT.FLOAT64 and isinstance(pe, PE.RandExpr) and pe.func == "randn":
            np.testing.assert_allclose(p.data.numpy()[live], np.asarray(j.data)[live],
                                       rtol=RANDN_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(p.data.numpy()[live], np.asarray(j.data)[live])
        np.testing.assert_array_equal(p.validity.numpy(), np.asarray(j.validity))


@pytest.mark.parametrize("lo,hi,seed", [(0.0, 0.3, 11), (0.3, 1.0, 11), (0.2, 0.2, 4)])
def test_sample_without_replacement_equals_jax(lo, hi, seed):
    """The same rows as the JAX package: complementary ranges split the
    live rows, an empty range keeps none."""
    jb, pb = stage([("x", lambda T: T.INT32)], {"x": np.arange(N, dtype=np.int32)}, mask=MASK)
    want = np.asarray(JBO.sample_op(jb, lo, hi, False, seed, 1).row_mask)
    got = PBO.sample_op(pb, lo, hi, False, seed, 1).row_mask.numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_with_replacement_counts_are_poisson():
    """Each live row copied Poisson(fraction) times (at most ceil + 3): the
    mean and variance of the copies near the fraction, no dead row
    copied, the copies of a row its own values."""
    n = 20_000
    b = PB.from_numpy({"x": np.arange(n, dtype=np.int64)}, PT.Schema([PT.Field("x", PT.INT64)]),
                      "cpu")
    mask = torch.from_numpy(np.arange(b.capacity) % 5 != 0) & b.row_mask
    out = PBO.sample_op(b.with_mask(mask), 0.0, 0.7, True, 3)
    x = out.columns[0].data[out.row_mask].numpy()
    counts = np.bincount(x, minlength=n)
    live = mask.numpy()[:n]
    assert counts[~live].sum() == 0
    c = counts[live]
    assert abs(c.mean() - 0.7) < 4 * math.sqrt(0.7 / len(c))
    assert abs(c.var() - 0.7) < 0.05
    assert c.max() <= math.ceil(0.7) + 3


def _sample_plan():
    sch = PT.Schema([PT.Field("k", PT.INT64), PT.Field("v", PT.INT64)])
    smp = PP.Sample(PP.Scan("t", sch), 0.0, 0.5, False, 7)
    return sch, smp.project([PE.col("k"), PE.Alias(PE.RandExpr("rand", 1), "r")]).aggregate(
        [PE.col("k")], [PE.AggExpr("sum", PE.col("r"), "r")])


def test_sample_through_every_walk():
    """bind, pruning, statistics, memory estimates, serde, the session (and
    Session.prepare) and the tiled-aggregate finder take a Sample."""
    sch, plan = _sample_plan()
    n = 4000
    rng = np.random.default_rng(1)
    data = {"k": rng.integers(0, 9, n), "v": np.arange(n, dtype=np.int64)}
    s = Session(device="cpu")
    s.register_numpy("t", data, sch)
    text = serde.plan_to_json(plan)
    assert serde.plan_to_json(serde.plan_from_json(text)) == text
    bound = PP.bind_plan(plan)
    assert bound.schema.names == ["k", "r"]
    got = s.collect(plan)
    again = PB.to_numpy(s.prepare(plan)())
    np.testing.assert_array_equal(got["r"], again["r"])
    assert find_stream_agg(bound, s.tables)[1] == "t"
    # the same rows as the sampled scan alone
    kept = s.collect(PP.Sample(PP.Scan("t", sch), 0.0, 0.5, False, 7))
    assert set(np.unique(kept["k"])) == set(got["k"])


def test_host_filter_and_runtime_filters_leave_rand_alone():
    """The host filter does not evaluate a conjunct with rand() (nor a cast
    that changes values), and a runtime filter's semi join stays above a
    Filter that draws rand()."""
    sch = PT.Schema([PT.Field("k", PT.INT64), PT.Field("t", PT.TIMESTAMP),
                     PT.Field("s", PT.string(8))])
    b = PB.from_numpy({"k": np.arange(8, dtype=np.int64),
                       "t": np.arange(8, dtype=np.int64) * 86_400_000_000,
                       "s": np.array(["1", "2", "x", "4", "5", "6", "7", "8"], object)},
                      sch, "cpu")
    for pred in (PE.RandExpr("rand", 1) < PE.lit(0.5),
                 PE.Cast(PE.col("t"), PT.DATE) == PE.lit(3, PT.DATE),
                 PE.Cast(PE.col("s"), PT.INT32) == PE.lit(4)):
        mask, applied = HF.eval_dim_filter(b, [pred])
        assert not applied and mask.all()
    flt = PP.Filter(PP.Scan("t", sch), PE.RandExpr("rand", 1) < PE.lit(0.5))
    assert RF._push_semi(flt, "k", None, None) is None
    assert RF._nondeterministic(PE.MonotonicallyIncreasingId())
    assert not RF._nondeterministic(PE.col("k") + PE.lit(1))


def test_rand_in_a_projection_equals_jax_through_the_sessions():
    """A filter, then rand per live row, through both sessions: the same
    rows in the same order, the same draws."""
    from datafusion_comet_tpu import types as JT
    from datafusion_comet_tpu.exec.engine import Session as JaxSession
    from datafusion_comet_tpu.ir import expr as JE
    from datafusion_comet_tpu.ir import plan as JP

    rng = np.random.default_rng(4)
    data = {"k": rng.integers(0, 50, 3000), "v": rng.integers(0, 9, 3000)}

    def plan(E, P, T):
        sch = T.Schema([T.Field("k", T.INT64), T.Field("v", T.INT64)])
        return P.Scan("t", sch).filter(E.col("v") > E.lit(2)).project(
            [E.col("k"), E.Alias(E.RandExpr("rand", 5), "r"),
             E.Alias(E.MonotonicallyIncreasingId(), "id")])

    js, ps = JaxSession(), Session(device="cpu")
    js.register_numpy("t", data, JT.Schema([JT.Field("k", JT.INT64), JT.Field("v", JT.INT64)]))
    ps.register_numpy("t", data, PT.Schema([PT.Field("k", PT.INT64), PT.Field("v", PT.INT64)]))
    want, got = js.collect(plan(JE, JP, JT)), ps.collect(plan(PE, PP, PT))
    for c in ("k", "r", "id"):
        np.testing.assert_array_equal(got[c], want[c])
