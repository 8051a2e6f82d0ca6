"""Hash join, INNER (port of the sorted-build path of
``datafusion_comet_tpu/exec/operators/join.py::hash_join``, :354 and
:626-660, with ``_key_limbs`` :45 and ``_harmonize_keys`` :56).

The build side is sorted once by (has no valid key, key limbs); every probe
row finds its run of equal build keys with two binary searches
(``torch.searchsorted``), and matches are laid out as a (probe x K) pair
block: row p*K + j pairs probe row p with its j-th build match. A probe row
with more than K matches raises the overflow flag and the session re-plans
with a larger K. Null keys never match (Spark's NullEqualsNothing).

The JAX package runs this path outside any Pallas kernel; its default
carry-range probe and its stats-driven variants (dense key ranges, packed
keys, compacted pair lists) are not ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec import sortkeys
from datafusion_comet_tpu_torch.exec.batch import Batch, ColumnVector
from datafusion_comet_tpu_torch.exec.dictionary import union_ranks
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext, evaluate, evaluate_predicate
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir.plan import JoinType

__all__ = ["hash_join", "JOIN_FANOUT", "MAX_JOIN_RETRIES"]

# The JAX Session's defaults (Session(join_fanout=4, max_join_retries=4)):
# a join's first K, the build matches each probe row may have before the run
# overflows and re-runs with K four times larger, and the runs before an
# overflow is an error.
JOIN_FANOUT = 4
MAX_JOIN_RETRIES = 4

_I64_MAX = (1 << 63) - 1


def _key_limbs(cols: Sequence[ColumnVector]) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Value limbs of the join keys and the all-keys-valid flag per row."""
    limbs: List[torch.Tensor] = []
    valid = cols[0].validity
    for cv in cols:
        limbs.extend(l.long() for l in sortkeys.column_limbs(cv))
        valid = valid & cv.validity
    return limbs, valid


def _harmonize_keys(build_keys: List[ColumnVector], probe_keys: List[ColumnVector]
                    ) -> Tuple[List[ColumnVector], List[ColumnVector]]:
    """Dictionary keys from different tables: remap both sides' codes to
    ranks in the union of the two dictionaries so they compare as int32."""
    out_b, out_p = [], []
    for b, p in zip(build_keys, probe_keys):
        if b.is_dict and p.is_dict and b.dictionary != p.dictionary:
            ra, rb = union_ranks(b.dictionary, p.dictionary)
            ra, rb = torch.from_numpy(ra).to(b.data.device), torch.from_numpy(rb).to(p.data.device)
            b = ColumnVector(ra[b.data.clamp(0, len(ra) - 1).long()], b.validity, None, T.INT32)
            p = ColumnVector(rb[p.data.clamp(0, len(rb) - 1).long()], p.validity, None, T.INT32)
        elif b.is_dict != p.is_dict:
            raise NotImplementedError("joining a dictionary key with a padded string key "
                                      "needs a decode, which is not ported yet")
        out_b.append(b)
        out_p.append(p)
    return out_b, out_p


def _one_limb(blimbs: List[torch.Tensor], plimbs: List[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse multi-limb keys into one int64 limb of the same order: the
    dense rank of each key tuple among both sides' tuples."""
    if len(blimbs) == 1:
        return blimbs[0], plimbs[0]
    nb = blimbs[0].shape[0]
    both = torch.stack([torch.cat([b, p]) for b, p in zip(blimbs, plimbs)], dim=1)
    _, rank = torch.unique(both, dim=0, return_inverse=True)
    return rank[:nb], rank[nb:]


def _repeat(cv: ColumnVector, k: int) -> ColumnVector:
    """Each row k times in a row (probe row p fills pair rows p*K .. p*K+K-1)."""
    rep = (lambda a: None if a is None else a.repeat_interleave(k, dim=0))
    return ColumnVector(rep(cv.data), rep(cv.validity), rep(cv.lengths), cv.dtype,
                        cv.dictionary)


def hash_join(left: Batch, right: Batch, left_keys: Sequence[E.Expr],
              right_keys: Sequence[E.Expr], join_type: str, build_side: str,
              out_schema: T.Schema, condition: Optional[E.Expr] = None,
              max_build_matches: int = 4, ctx: Optional[EvalContext] = None
              ) -> Tuple[Batch, torch.Tensor]:
    """Returns (joined batch of capacity probe x K, overflow flag: some probe
    row had more than K = ``max_build_matches`` matches, so the result is
    incomplete and the caller must re-run with a larger K)."""
    if join_type != JoinType.INNER:
        raise NotImplementedError(f"{join_type} joins are not ported yet (INNER only)")
    ctx = ctx or EvalContext()
    if build_side == "left":
        build, probe, build_keys, probe_keys = left, right, left_keys, right_keys
    else:
        build, probe, build_keys, probe_keys = right, left, right_keys, left_keys
    K = max_build_matches
    bcap, pcap, dev = build.capacity, probe.capacity, probe.device

    bcols, pcols = _harmonize_keys([evaluate(k, build, ctx) for k in build_keys],
                                   [evaluate(k, probe, ctx) for k in probe_keys])
    blimbs, bvalid = _key_limbs(bcols)
    plimbs, pvalid = _key_limbs(pcols)
    bvalid = bvalid & build.row_mask
    pvalid = pvalid & probe.row_mask
    bkey, pkey = _one_limb(blimbs, plimbs)

    # build rows with a valid key first, by key; the rest get the largest
    # key so the sorted sequence stays ordered, and every search is clamped
    # to the n_build valid rows
    bperm = sortkeys.lexsort([(~bvalid).int(), bkey])
    n_build = bvalid.sum()
    sorted_key = torch.where(bvalid[bperm], bkey[bperm], _I64_MAX).contiguous()
    pk = pkey.contiguous()
    lo = torch.minimum(torch.searchsorted(sorted_key, pk, side="left"), n_build)
    hi = torch.minimum(torch.searchsorted(sorted_key, pk, side="right"), n_build)
    count = torch.where(pvalid, hi - lo, 0)
    overflow = (count > K).any()

    j = torch.arange(K, device=dev).repeat(pcap)
    pair_valid = j < count.clamp(max=K).repeat_interleave(K)
    b_idx = bperm[(lo.repeat_interleave(K) + j).clamp(0, max(bcap - 1, 0))]
    probe_cols = [_repeat(c, K) for c in probe.columns]
    build_cols = [c.take(b_idx) for c in build.columns]
    if build_side == "left":
        pair_cols, pair_fields = build_cols + probe_cols, build.schema.fields + probe.schema.fields
    else:
        pair_cols, pair_fields = probe_cols + build_cols, probe.schema.fields + build.schema.fields
    if condition is not None:
        pair = Batch(tuple(pair_cols), pair_valid, T.Schema(list(pair_fields)))
        pair_valid = evaluate_predicate(condition, pair, ctx)
    return Batch(tuple(pair_cols), pair_valid, out_schema), overflow
