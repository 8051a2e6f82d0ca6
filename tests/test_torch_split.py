"""The port's Split against the JAX package and Python on the CPU:
split(str, literal delimiter) with limit -1 over padded and
dictionary-coded strings (trailing empty fields kept, a null string a null
list), and more fields than ``max_parts`` raising QueryExecutionError
naming the cap through both packages' sessions."""

import numpy as np
import pytest

from _torch_nested import assert_same, run_all, stage
from _torch_threads import one_torch_thread  # noqa: F401

from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROWS = {"t": ["a,b,,c", "", None, ",", "one", "x,y", "a,b,c,d,e", ",,"],
        "u": ["x--y", "--", "a", None, "p--q--r", "--a--", "b", ""]}
N = 8


@pytest.fixture(scope="module")
def batches():
    return stage([("t", lambda T: T.string(12)), ("u", lambda T: T.string(10))], ROWS)


def test_split_equals_jax_and_python(batches):
    """split over padded strings equals JAX's and Python's str.split."""
    jb, pb = batches
    build = lambda E, T: E.Split(E.col("t"), ",", 4)  # noqa: E731
    [(jcv, pcv, jerr, perr)] = run_all([build], jb, pb)
    assert_same(jcv, pcv, N)
    got = PB.nested_to_py(pcv, np.arange(N))
    for i, t in enumerate(ROWS["t"]):
        if i == 6:  # five fields, past the cap of four: flagged
            continue
        assert got[i] == (None if t is None else t.split(",")), (i, got[i])
    assert [m for _, m in perr] == [m for _, m in jerr]
    assert perr[0][1].startswith("split produced more than max_parts=4 fields")
    assert perr[0][0].numpy()[:N].tolist() == [i == 6 for i in range(N)]


def test_split_cap_raises_through_the_session():
    """A row with more fields than the cap raises QueryExecutionError
    naming the cap, as in the JAX package."""
    from datafusion_comet_tpu.exec.engine import QueryExecutionError as JErr
    from datafusion_comet_tpu.exec.engine import Session as JSession
    from datafusion_comet_tpu.ir import expr as JE
    from datafusion_comet_tpu.ir import plan as JP
    from datafusion_comet_tpu import types as JT
    from datafusion_comet_tpu_torch.exec.engine import QueryExecutionError, Session
    from datafusion_comet_tpu_torch.ir import expr as PE
    from datafusion_comet_tpu_torch.ir import plan as PP

    data = {"t": np.array(["a b", "a b c d", "x"], dtype=object)}
    msgs = []
    for sess, E, P, T, err in ((Session(device="cpu"), PE, PP, PT, QueryExecutionError),
                               (JSession(), JE, JP, JT, JErr)):
        sch = T.Schema([T.Field("t", T.string(8))])
        sess.register_numpy("w", data, sch)
        plan = P.Scan("w", sch).project([E.Alias(E.Split(E.col("t"), " ", 3), "p")])
        with pytest.raises(err) as info:
            sess.collect(plan)
        msgs.append(str(info.value))
    assert "max_parts=3" in msgs[0] and "max_parts=3" in msgs[1]


def test_split_of_a_two_byte_delimiter_and_of_dictionary_strings(batches):
    """A two-byte delimiter's matches do not overlap; a dictionary column is
    split over its entries and gathered back, equal to the padded one."""
    jb, pb = batches
    [(jcv, pcv, _, _)] = run_all([lambda E, T: E.Split(E.col("u"), "--", 4)], jb, pb)
    assert_same(jcv, pcv, N)
    got = PB.nested_to_py(pcv, np.arange(N))
    assert got == [None if u is None else u.split("--") for u in ROWS["u"]]
    from datafusion_comet_tpu_torch.exec import evaluator as PEV
    from datafusion_comet_tpu_torch.ir import expr as PE

    sch = PT.Schema([PT.Field("u", PT.string(10))])
    dict_b = PB.from_numpy({"u": np.array(ROWS["u"], dtype=object)}, sch, "cpu")
    assert dict_b.columns[0].is_dict
    cv = PEV.evaluate(PE.bind(PE.Split(PE.col("u"), "--", 4), sch), dict_b)
    assert PB.nested_to_py(cv, np.arange(N)) == got
