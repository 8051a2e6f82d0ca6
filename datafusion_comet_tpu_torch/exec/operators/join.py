"""Hash join: INNER, and the semi-like LEFT_SEMI, LEFT_ANTI and EXISTENCE
(port of ``datafusion_comet_tpu/exec/operators/join.py::hash_join``, :354;
the sorted-build path :626-660 and :740-756, the dense-bitmap membership
path :433-466, ``_key_limbs`` :45 and ``_harmonize_keys`` :56).

The build side is sorted once by (has no valid key, key limbs); every probe
row finds its run of equal build keys with two binary searches
(``torch.searchsorted``). An INNER join lays its matches out as a (probe x
K) pair block: row p*K + j pairs probe row p with its j-th build match. A
probe row with more than K matches raises the overflow flag and the session
re-plans with a larger K. Null keys never match (Spark's NullEqualsNothing).

A semi-like join keeps the probe (left) side and needs only whether each
probe row has a match: LEFT_SEMI keeps the rows that do, LEFT_ANTI the rows
that do not (a null key never matches, so it passes), EXISTENCE keeps every
row and appends a non-null BOOL ``exists``. When the single integer or date
build key has an exact range (``build_key_range``, from statistics) whose
span is at most 2^24, membership is one scatter into a span + 1 boolean
bitmap and one gather for the probe, with no sort; else the match count of
the sorted path decides (count > 0), and no pair block is built. So a
semi-like join never overflows: the JAX package raises its fan-out flag on
this path when a probe row has more than K matches (its unused pair block
is cut off) and re-runs with a larger K; the port raises none, and the
results are the same.

The JAX package runs these paths outside any Pallas kernel; its default
carry-range probe and its stats-driven INNER variants (dense key ranges,
packed keys, compacted pair lists), null-aware anti joins and semi-like
joins with a condition are not ported.
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

__all__ = ["hash_join", "SEMI_LIKE", "JOIN_FANOUT", "MAX_JOIN_RETRIES"]

# The JAX Session's defaults (Session(join_fanout=4, max_join_retries=4)):
# a join's first K, the build matches each probe row may have before the run
# overflows and re-runs with K four times larger, and the runs before an
# overflow is an error.
JOIN_FANOUT = 4
MAX_JOIN_RETRIES = 4

_I64_MAX = (1 << 63) - 1
_BITMAP_SPAN = 1 << 24  # the largest build-key span the membership bitmap covers
SEMI_LIKE = (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI, JoinType.EXISTENCE)


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
    if len(blimbs) != len(plimbs):
        # a narrow decimal key against a two-limb one: neither package lifts
        # one side to the other's storage
        raise NotImplementedError("join keys of different storage (narrow int64 against "
                                  "two-limb decimal) are not supported")
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


def _bitmap_ok(bcols: List[ColumnVector], pcols: List[ColumnVector], key_range) -> bool:
    """Whether membership can be a bitmap over the build key's exact span:
    one integer or date key (no dictionary codes on either side) whose
    range is known and at most 2^24 wide."""
    if len(bcols) != 1 or key_range is None or bcols[0].is_dict or pcols[0].is_dict:
        return False
    dt = bcols[0].dtype
    span = int(key_range[1]) - int(key_range[0]) + 1
    return (dt.is_integer or dt.type_id == "DATE") and 0 < span <= _BITMAP_SPAN


def _bitmap_member(bkey: torch.Tensor, bvalid: torch.Tensor, pkey: torch.Tensor,
                   pvalid: torch.Tensor, key_range) -> torch.Tensor:
    """Per probe row, whether its key is among the valid build keys: one
    scatter into a span + 1 bitmap (slot ``span`` takes the dead and
    out-of-range build rows) and one gather. An out-of-range or invalid
    probe key never reads the sink slot as a hit."""
    lo = int(key_range[0])
    span = int(key_range[1]) - lo + 1
    bk = bkey.long() - lo
    table = torch.zeros(span + 1, dtype=torch.bool, device=bkey.device)
    table[torch.where(bvalid & (bk >= 0) & (bk < span), bk, span)] = True
    pk = pkey.long() - lo
    in_rng = (pk >= 0) & (pk < span)
    return table[torch.where(in_rng, pk, span)] & pvalid & in_rng


def _sorted_matches(bkey: torch.Tensor, bvalid: torch.Tensor, pkey: torch.Tensor,
                    pvalid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(build permutation, start of each probe row's run in it, run length):
    build rows with a valid key first, by key; the rest get the largest key
    so the sorted sequence stays ordered, and every search is clamped to
    the valid build rows. Invalid probe rows count 0."""
    bperm = sortkeys.lexsort([(~bvalid).int(), bkey])
    n_build = bvalid.sum()
    sorted_key = torch.where(bvalid[bperm], bkey[bperm], _I64_MAX).contiguous()
    pk = pkey.contiguous()
    lo = torch.minimum(torch.searchsorted(sorted_key, pk, side="left"), n_build)
    hi = torch.minimum(torch.searchsorted(sorted_key, pk, side="right"), n_build)
    return bperm, lo, torch.where(pvalid, hi - lo, 0)


def hash_join(left: Batch, right: Batch, left_keys: Sequence[E.Expr],
              right_keys: Sequence[E.Expr], join_type: str, build_side: str,
              out_schema: T.Schema, condition: Optional[E.Expr] = None,
              max_build_matches: int = 4, ctx: Optional[EvalContext] = None,
              build_key_range: Optional[Tuple[int, int]] = None
              ) -> Tuple[Batch, torch.Tensor]:
    """Returns (joined batch, overflow flag). INNER: the (probe x K) pair
    block, and the flag set where some probe row had more than K =
    ``max_build_matches`` matches, so the result is incomplete and the
    caller must re-run with a larger K. Semi-like: the probe's columns at
    its capacity (EXISTENCE adds ``exists``), and a flag never set.
    ``build_key_range``: the exact (min, max) of a single build key, which
    lets a semi-like join use the membership bitmap."""
    semi = join_type in SEMI_LIKE
    if join_type != JoinType.INNER and not semi:
        raise NotImplementedError(f"{join_type} joins are not ported yet")
    if semi and condition is not None:
        raise NotImplementedError(f"{join_type} joins with a condition are not ported yet")
    ctx = ctx or EvalContext()
    if build_side == "left":
        assert not semi, "semi and anti joins keep the left (probe) side"
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
    no_overflow = torch.zeros((), dtype=torch.bool, device=dev)

    if semi:
        if _bitmap_ok(bcols, pcols, build_key_range):
            hash_join.semi_paths["bitmap"] += 1
            hit = _bitmap_member(bcols[0].data, bvalid, pcols[0].data, pvalid, build_key_range)
        else:
            hash_join.semi_paths["sorted"] += 1
            bkey, pkey = _one_limb(blimbs, plimbs)
            hit = _sorted_matches(bkey, bvalid, pkey, pvalid)[2] > 0
        if join_type == JoinType.LEFT_SEMI:
            return Batch(probe.columns, probe.row_mask & hit, out_schema), no_overflow
        if join_type == JoinType.LEFT_ANTI:
            return Batch(probe.columns, probe.row_mask & ~hit, out_schema), no_overflow
        exists = ColumnVector(hit, torch.ones(pcap, dtype=torch.bool, device=dev), None, T.BOOL)
        return Batch(tuple(probe.columns) + (exists,), probe.row_mask, out_schema), no_overflow

    bkey, pkey = _one_limb(blimbs, plimbs)
    bperm, lo, count = _sorted_matches(bkey, bvalid, pkey, pvalid)
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


# the semi-like joins run by each membership path, counted where they run
hash_join.semi_paths = {"bitmap": 0, "sorted": 0}
