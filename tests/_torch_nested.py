"""Shared helpers of the port's nested-type parity tests: one set of
Python rows staged in both packages, expressions built from either
package's IR, the JAX side evaluated in one ``jax.jit`` for all of a
test's expressions, and the results compared as Python values (floats by
their bits, so NaN equals NaN and -0.0 is not 0.0) and, for lists and
maps, by their element counts and validity."""

import numpy as np
import torch

import jax
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec import evaluator as JEV
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.ir import expr as PE


def stage(fields, data):
    """fields: [(name, fn(T) -> dtype)], data: {name: list of Python
    values}; -> (jax batch, port batch), strings padded."""
    jb = JB.from_numpy(data, JT.Schema([JT.Field(n, f(JT)) for n, f in fields]),
                       dictionary=False)
    pb = PB.from_numpy(data, PT.Schema([PT.Field(n, f(PT)) for n, f in fields]), "cpu",
                       dict_max_size=0)
    return jb, pb


def canon(v):
    """A Python value with every float as its bits."""
    if isinstance(v, float):
        return ("f", np.float64(v).tobytes())
    if isinstance(v, list):
        return [canon(x) for x in v]
    if isinstance(v, dict):
        return {k if not isinstance(k, float) else canon(k): canon(x) for k, x in v.items()}
    return v


def run_all(builds, jb, pb):
    """[(jax values, port values, jax errors, port errors)] of each build
    (E, T) -> expression over the first rows of the batches, the JAX side
    in one jit; lists and maps also compare their counts and validity."""
    jes = [JE.bind(b(JE, JT), jb.schema) for b in builds]
    pes = [PE.bind(b(PE, PT), pb.schema) for b in builds]
    for je, pe in zip(jes, pes):
        assert repr(je.dtype) == repr(pe.dtype), (je.dtype, pe.dtype)
    msgs = []

    def jax_side(batch):
        outs = []
        msgs.clear()
        for je in jes:
            ctx = JEV.EvalContext(errors=[])
            cv = JEV.evaluate(je, batch, ctx)
            outs.append((cv.decode() if cv.is_dict else cv, [f for f, _ in ctx.errors]))
            msgs.append([m for _, m in ctx.errors])
        return outs

    out = []
    for (jcv, jflags), m, pe in zip(jax.jit(jax_side)(jb), msgs, pes):
        pctx = PEV.EvalContext(errors=[])
        pcv = PEV.evaluate(pe, pb, pctx)
        out.append((jcv, pcv, list(zip(jflags, m)), pctx.errors))
    return out


def assert_same(jcv, pcv, n):
    """Equal Python values of the first ``n`` rows; a list's or map's
    element counts and validity equal on its valid rows."""
    idx = np.arange(n)
    jv = JB.nested_to_py(jcv, idx) if jcv.dtype.is_nested else _flat(jcv, n, True)
    pv = PB.nested_to_py(pcv, idx) if pcv.dtype.is_nested else _flat(pcv, n, False)
    assert canon(jv) == canon(pv), (jv, pv)
    if pcv.dtype.is_list or pcv.dtype.is_map:
        ok = np.asarray(jcv.validity)[:n]
        np.testing.assert_array_equal(ok, pcv.validity.numpy()[:n])
        np.testing.assert_array_equal(np.asarray(jcv.data)[:n][ok], pcv.data.numpy()[:n][ok])


def _flat(cv, n, jax):
    if cv.dictionary is not None:
        cv = cv.decode()
    valid = np.asarray(cv.validity)[:n] if jax else cv.validity.numpy()[:n]
    data = np.asarray(cv.data) if jax else cv.data.numpy()
    if cv.lengths is not None:
        lens = np.asarray(cv.lengths) if jax else cv.lengths.numpy()
        return [bytes(data[i, : lens[i]].astype(np.uint8)) if valid[i] else None
                for i in range(n)]
    return [data[i].item() if valid[i] else None for i in range(n)]


def assert_same_errors(jerrs, perrs, mask=None):
    """The same error messages, flagged on the same rows (``mask``: the
    live rows that count)."""
    assert [m for _, m in jerrs] == [m for _, m in perrs]
    for (jf, _), (pf, _) in zip(jerrs, perrs):
        j, p = np.asarray(jf), pf.numpy()
        if mask is not None:
            j, p = j[: len(mask)] & mask, p[: len(mask)] & mask
        np.testing.assert_array_equal(j, p)


def to_torch(a):
    return torch.from_numpy(np.asarray(a))
