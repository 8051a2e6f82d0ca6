"""Shared helpers of the port's expression parity tests: one set of numpy
columns staged in both packages (padded, or with strings dictionary-coded),
expressions built from either package's IR, both evaluated, and the
results compared row by row on the valid rows. ``run_all`` evaluates a
test's expressions on the JAX side in one jitted computation (one compile
instead of one per primitive and shape); ``run_both`` one expression
eagerly, where a jitted division by a constant would multiply by its
reciprocal on XLA's CPU (ROADMAP C30)."""

from types import SimpleNamespace

import numpy as np
import torch

import jax
import jax.numpy as jnp
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec import evaluator as JEV
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.ir import expr as PE

PKGS = {"jax": (JE, JT), "port": (PE, PT)}


def stage(fields, data, validity=None, dict_strings=False, mask=None):
    """fields: [(name, fn(T) -> dtype)]; -> (jax batch, port batch). With
    ``dict_strings`` strings are dictionary-coded, else padded; ``mask``
    kills rows (dead rows)."""
    dmax = 1 << 16 if dict_strings else 0
    jb = JB.from_numpy(data, JT.Schema([JT.Field(n, f(JT)) for n, f in fields]),
                       validity=validity, dictionary=dict_strings)
    pb = PB.from_numpy(data, PT.Schema([PT.Field(n, f(PT)) for n, f in fields]), "cpu",
                       validity=validity, dict_max_size=dmax)
    if mask is not None:
        cap = pb.capacity
        m = np.zeros(cap, bool)
        m[: len(mask)] = mask
        jb = jb.with_mask(jnp.asarray(m) & jb.row_mask)
        pb = pb.with_mask(torch.from_numpy(m) & pb.row_mask)
    return jb, pb


def run_both(build, jb, pb, mode_ctx=False):
    """build(E, T) -> expression; -> (jax cv, port cv[, jax errors, port
    errors])."""
    je = JE.bind(build(JE, JT), jb.schema)
    pe = PE.bind(build(PE, PT), pb.schema)
    assert repr(je.dtype) == repr(pe.dtype), (je.dtype, pe.dtype)
    if mode_ctx:
        jctx, pctx = JEV.EvalContext(errors=[]), PEV.EvalContext(errors=[])
        return JEV.evaluate(je, jb, jctx), PEV.evaluate(pe, pb, pctx), jctx.errors, pctx.errors
    return JEV.evaluate(je, jb), PEV.evaluate(pe, pb)


def run_all(builds, jb, pb, mode_ctx=False):
    """run_both over a list of builds, the JAX side in one ``jax.jit``:
    [(jax result, port result[, jax errors, port errors])]."""
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
            cv = cv.decode() if cv.is_dict else cv
            outs.append((cv.data, cv.validity, cv.lengths, [f for f, _ in ctx.errors]))
            msgs.append([m for _, m in ctx.errors])
        return outs

    jouts = jax.jit(jax_side)(jb)
    out = []
    for (d, v, ln, flags), m, pe in zip(jouts, msgs, pes):
        j = SimpleNamespace(data=d, validity=v, lengths=ln, dictionary=None)
        if mode_ctx:
            pctx = PEV.EvalContext(errors=[])
            out.append((j, PEV.evaluate(pe, pb, pctx), list(zip(flags, m)), pctx.errors))
        else:
            out.append((j, PEV.evaluate(pe, pb)))
    return out


def values(cv, n, jax=False):
    """The first n rows of a result as (python values, validity); strings
    as bytes (dictionary columns decoded)."""
    if cv.dictionary is not None:
        cv = cv.decode()
    valid = np.asarray(cv.validity if jax else cv.validity.numpy())[:n]
    data = np.asarray(cv.data) if jax else cv.data.numpy()
    if cv.lengths is not None:
        lens = np.asarray(cv.lengths) if jax else cv.lengths.numpy()
        out = [bytes(data[i, : lens[i]].astype(np.uint8)) if valid[i] else None
               for i in range(n)]
    else:
        out = [data[i].item() if valid[i] else None for i in range(n)]
    return out, valid


def assert_same(jcv, pcv, n, rows=None):
    """Equal validity and equal values on the valid rows (``rows``: only
    those), floats bit for bit (NaN equal to NaN)."""
    jv, jok = values(jcv, n, jax=True)
    pv, pok = values(pcv, n)
    idx = range(n) if rows is None else rows
    for i in idx:
        assert jok[i] == pok[i], (i, jv[i], pv[i])
        if jok[i]:
            a, b = jv[i], pv[i]
            if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
                continue
            assert a == b and (not isinstance(a, float) or
                               np.float64(a).tobytes() == np.float64(b).tobytes()), \
                (i, a, b)


def assert_same_errors(jerrs, perrs):
    assert [m for _, m in jerrs] == [m for _, m in perrs]
    for (jf, _), (pf, _) in zip(jerrs, perrs):
        np.testing.assert_array_equal(np.asarray(jf), pf.numpy())
