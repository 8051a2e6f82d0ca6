"""Hash join: INNER, the outer LEFT, RIGHT and FULL, and the semi-like
LEFT_SEMI, LEFT_ANTI and EXISTENCE, and the broadcast nested-loop join
(``nested_loop_join``, JAX :778-830)
(port of ``datafusion_comet_tpu/exec/operators/join.py::hash_join``, :354;
the key packing :400-419, the unique build :551-581, the compacted pair
list :586-614, the sorted-build path :626-660 and :740-756, the
dense-bitmap membership path :433-466, ``_key_limbs`` :45 and
``_harmonize_keys`` :56). Keys are integers, dates, decimals or strings:
dictionary codes, or padded bytes whose big-endian limbs
(sortkeys.column_limbs) collapse into one by their dense rank.

The build side is sorted once by (has no valid key, key limbs); every probe
row finds its run of equal build keys with two binary searches
(``torch.searchsorted``). Null keys never match (Spark's
NullEqualsNothing). An INNER join lays its matches out on one of four
paths, which the planner's hints select (exec/stats.py, exec/engine.py):

- **unique build, dense**: the build keys are hinted unique and the single
  integer or date build key has an exact range of span at most 2^24. The
  build rows' positions and counts are scattered into span + 1 slots (slot
  ``span`` is a sink no probe reads); each probe row finds its match with
  one gather. No sort.
- **unique build, sorted**: hinted unique, any other key. Each probe row
  takes the first row of its run.
  Both unique paths emit one pair slot per probe row, at the probe's
  capacity, and raise the overflow flag where a valid build key repeats:
  the session then re-runs without the hint.
- **compacted pair list** (``compact_rows``, from the join's row
  estimate): the match counts' exclusive cumulative sum gives each probe
  row its first output slot; each of the ``compact_rows`` slots finds its
  probe row by a binary search in the cumulative sum and its build row at
  the run's start plus its offset. Pairs come out by probe row, then by
  build row within a key. More pairs than slots raise the flag. No
  (probe x K) block exists.
- **pair block**: row p*K + j pairs probe row p with its j-th build match;
  a probe row with more than K matches raises the flag and the session
  re-plans with a larger K.

An outer join (JAX ``join.py:597-600``, ``:704-736``) runs on the same
four paths. Its output is INNER's pairs plus each live probe row without a
match (a null key never matches) once, in its first slot (j = 0), with a
null build side; on the compacted list every live probe row holds at least
one slot. With a condition, a probe row is matched where one of its pairs
passes it. FULL appends a tail of build capacity in which the build rows
that no pair matched come out with a null probe side. LEFT probes its left
input and RIGHT its right one; FULL probes either.

A multi-key join with ``key_pack`` (per key, the (min, max) over both
sides) packs the key tuple into one int64, (k1 - lo1) + (k2 - lo2) x span1
+ ...; a valid key outside its range raises the flag and the retry runs
without packing. Without it, several key limbs collapse into one by their
dense rank over both sides (``_one_limb``).

A semi-like join keeps the probe (left) side and needs only whether each
probe row has a match: LEFT_SEMI keeps the rows that do, LEFT_ANTI the rows
that do not (a null key never matches, so it passes), EXISTENCE keeps every
row and appends a non-null BOOL ``exists``. When the single integer or date
build key has an exact range (``dense_range``, a runtime filter's key range,
else ``build_key_range``, from statistics) whose span is at most 2^24,
membership is one scatter into a span + 1 boolean bitmap and one gather for
the probe, with no sort; else the match count of
the sorted path decides (count > 0), and no pair block is built. So a
semi-like join without a condition never overflows: the JAX package raises
its fan-out flag on this path when a probe row has more than K matches (its
unused pair block is cut off) and re-runs with a larger K; the port raises
none, and the results are the same.

A semi-like join with a condition (JAX ``join.py:468-549``, ``:640-700``)
takes the min/max pushdown where the condition is one comparison (ne, lt,
le, gt, ge) between a bare build column and an expression of the probe side
only, integers or dates on both sides (``_semi_cond_decompose``): EXISTS(b
in the key's run: b.c OP e) is min(c) OP e or max(c) OP e over the run (ne:
min != e or max != e). Where the key takes the bitmap's range and the
condition column's exact range (``cond_col_ranges``) fits a biased int32,
one ``amin`` and one ``amax`` scatter over the key span and one gather give
each probe row its run's (min, max) (``minmax_dense``); else the sorted
build's runs are reduced once and read at each probe row's run start
(``minmax_sorted``, in place of the JAX package's concatenated sort and
associative scan). Null keys and null condition values are left out. Any
other condition runs on the pairs of the INNER paths and is folded back per
probe row (``pairs``), with the INNER paths' overflow flag and retry.

The null-aware anti join (LEFT_ANTI_NULL_AWARE, Spark's plan of ``NOT IN
(subquery)``, JAX ``join.py:749-755``) takes every path of the other
semi-like joins and keeps the probe rows with no match, as LEFT_ANTI does,
but for NOT IN's nulls: no probe row passes where any live build row has a
null key, and a probe row with a null key never passes.

The merge path (``presorted_build``, a SortMergeJoin whose build child is
sorted ascending on its keys, nulls last: JAX ``join.py:628-634``) searches
the build rows in the order they come, without sorting them, where the one
search key is monotone in that order: a single integer, date or narrow
decimal key, not dictionary codes, and not lifted to two limbs (C5). Its
rows with no valid key, dead rows included, are the last ones there, as the
Sort below the join leaves them. Any other key sorts the build side, the
path the JAX package takes where the flag is not set; ``join_log`` says
which (``merge``).

The JAX package runs these paths outside any Pallas kernel. Its carry-range
probe (a concatenated sort of both sides) is replaced here by the binary
searches, which give each probe row the same run in the same order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec import decimal_wide as DW
from datafusion_comet_tpu_torch.exec import sortkeys
from datafusion_comet_tpu_torch.exec.batch import Batch, ColumnVector, _concat_column, map_buffers
from datafusion_comet_tpu_torch.exec.dictionary import union_ranks
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext, evaluate, evaluate_predicate
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir.plan import JoinType

__all__ = ["hash_join", "nested_loop_join", "SEMI_LIKE", "OUTER", "JOIN_FANOUT",
           "MAX_JOIN_RETRIES"]

# The JAX Session's defaults (Session(join_fanout=4, max_join_retries=4)):
# a join's first K, the build matches each probe row may have before the run
# overflows and re-runs with K four times larger, and the runs before an
# overflow is an error.
JOIN_FANOUT = 4
MAX_JOIN_RETRIES = 4

_I64_MAX = (1 << 63) - 1
_BITMAP_SPAN = 1 << 24  # the largest build-key span the membership bitmap covers
SEMI_LIKE = (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI, JoinType.LEFT_ANTI_NULL_AWARE,
             JoinType.EXISTENCE)
OUTER = (JoinType.LEFT, JoinType.RIGHT, JoinType.FULL)


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
    ranks in the union of the two dictionaries so they compare as int32. A
    dictionary key against a padded one: both decoded (JAX ``join.py:72``).
    A narrow decimal key against a two-limb one: the narrow side lifted to
    two limbs, so equal values compare equal (the JAX package compares the
    storages as they are and finds no match, ROADMAP C5)."""
    out_b, out_p = [], []
    for b, p in zip(build_keys, probe_keys):
        if b.dtype.is_decimal and p.dtype.is_decimal and b.is_wide_storage != p.is_wide_storage:
            b, p = _two_limb(b), _two_limb(p)
        elif b.is_dict and p.is_dict and b.dictionary != p.dictionary:
            ra, rb = union_ranks(b.dictionary, p.dictionary)
            ra, rb = torch.from_numpy(ra).to(b.data.device), torch.from_numpy(rb).to(p.data.device)
            b = ColumnVector(ra[b.data.clamp(0, len(ra) - 1).long()], b.validity, None, T.INT32)
            p = ColumnVector(rb[p.data.clamp(0, len(rb) - 1).long()], p.validity, None, T.INT32)
        elif b.is_dict != p.is_dict:
            b, p = b.decode(), p.decode()
        out_b.append(b)
        out_p.append(p)
    return out_b, out_p


def _two_limb(cv: ColumnVector) -> ColumnVector:
    """A decimal key in two-limb storage."""
    if cv.is_wide_storage:
        return cv
    return ColumnVector(DW.pack(DW.lift(cv)), cv.validity, None, cv.dtype)


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


def _packable(cols: Sequence[ColumnVector], key_pack) -> bool:
    """Whether ``key_pack`` applies: one range per key, and every key an
    integer or date without dictionary codes."""
    return key_pack is not None and len(key_pack) == len(cols) // 2 and all(
        not c.is_dict and (c.dtype.is_integer or c.dtype.type_id == "DATE") for c in cols)


def _pack(cols: Sequence[ColumnVector], key_pack
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(packed int64 key, all-keys-valid, valid but out of range): each key
    clamped into its range, offset by its minimum and scaled by the spans
    of the keys before it."""
    acc = torch.zeros(cols[0].data.shape[0], dtype=torch.int64, device=cols[0].data.device)
    oor = torch.zeros_like(acc, dtype=torch.bool)
    valid = cols[0].validity
    stride = 1
    for cv, (lo, hi) in zip(cols, key_pack):
        valid = valid & cv.validity
        k = cv.data.long()
        oor = oor | (k < lo) | (k > hi)
        acc = acc + (k.clamp(lo, hi) - lo) * stride
        stride *= hi - lo + 1
    return acc, valid, oor & valid


def _repeat(cv: ColumnVector, k: int) -> ColumnVector:
    """Each row k times in a row (probe row p fills pair rows p*K .. p*K+K-1;
    a nested column's children too, JAX ``join.py:106``)."""
    return map_buffers(cv, lambda a: a.repeat_interleave(k, dim=0))


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


def _dense_unique(bkey: torch.Tensor, bvalid: torch.Tensor, pkey: torch.Tensor,
                  pvalid: torch.Tensor, key_range
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(build row of each probe row, matched, duplicate flag) over the
    build key's exact span: each valid build row's position + 1 and a count
    scattered into its key's slot (slot ``span`` sinks the rest), one
    gather for the probe. A slot counted twice is a duplicate key."""
    lo = int(key_range[0])
    span = int(key_range[1]) - lo + 1
    bcap = bkey.shape[0]
    bk = bkey.long() - lo
    bslot = torch.where(bvalid & (bk >= 0) & (bk < span), bk, span)
    pos = torch.arange(1, bcap + 1, device=bkey.device)
    tpos = torch.zeros(span + 1, dtype=torch.int64, device=bkey.device).scatter_reduce_(
        0, bslot, pos, "amax")
    dup = (torch.bincount(bslot, minlength=span + 1)[:span] > 1).any()
    pk = pkey.long() - lo
    in_rng = (pk >= 0) & (pk < span)
    hit = tpos[torch.where(in_rng & pvalid, pk, span)]
    matched = (hit > 0) & in_rng & pvalid
    return (hit - 1).clamp(0, max(bcap - 1, 0)), matched, dup


def _sorted_build(bkey: torch.Tensor, bvalid: torch.Tensor, presorted: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(build permutation, sorted keys, valid build rows): rows with a
    valid key first, by key; the rest get the largest key so the sorted
    sequence stays ordered. ``presorted``: the rows come in that order
    already (the merge path), and the permutation is the identity."""
    if presorted:
        bperm = torch.arange(bkey.shape[0], device=bkey.device)
        return bperm, torch.where(bvalid, bkey, _I64_MAX).contiguous(), bvalid.sum()
    bperm = sortkeys.lexsort([(~bvalid).int(), bkey])
    sorted_key = torch.where(bvalid[bperm], bkey[bperm], _I64_MAX).contiguous()
    return bperm, sorted_key, bvalid.sum()


def _merge_ok(cv: ColumnVector) -> bool:
    """Whether a build key's one search limb keeps the order its column
    sorts in: an integer, date or narrow decimal, not dictionary codes."""
    dt = cv.dtype
    return (not cv.is_dict and not cv.is_wide_storage and cv.data.dim() == 1
            and (dt.is_integer or dt.type_id == "DATE" or dt.is_decimal))


def _sorted_matches(bkey: torch.Tensor, bvalid: torch.Tensor, pkey: torch.Tensor,
                    pvalid: torch.Tensor, sorted_build=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(build permutation, start of each probe row's run in it, run length):
    every search is clamped to the valid build rows. Invalid probe rows
    count 0."""
    bperm, sorted_key, n_build = sorted_build or _sorted_build(bkey, bvalid)
    pk = pkey.contiguous()
    lo = torch.minimum(torch.searchsorted(sorted_key, pk, side="left"), n_build)
    hi = torch.minimum(torch.searchsorted(sorted_key, pk, side="right"), n_build)
    return bperm, lo, torch.where(pvalid, hi - lo, 0)


_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "ne": "ne"}
_CMP = {"lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge}
_I64_MIN = -(1 << 63)
_BIAS_MAX = (1 << 31) - 4  # the largest biased condition value of the dense table
_EMPTY = (1 << 31) - 2     # the dense table's empty-slot minimum


def _refs(e: E.Expr) -> set:
    out = {e.index} if isinstance(e, E.BoundRef) else set()
    for c in e.children():
        out |= _refs(c)
    return out


def _int_like(dt: Optional[T.DataType]) -> bool:
    return dt is not None and (dt.is_integer or dt.type_id == "DATE")


def _semi_cond_decompose(cond: E.Expr, nprobe: int):
    """(op as ``build OP probe``, the build column's index in the build
    schema, the probe expression) where the pair-bound condition is one
    comparison between a bare build column and an expression of probe
    columns only, in either orientation, integers or dates on both sides;
    else None (JAX ``join.py:263``). The probe fields lead the pair schema,
    so the expression evaluates on the probe batch as it is bound."""
    e = cond
    while isinstance(e, E.Alias):
        e = e.child
    if not isinstance(e, E.BinaryOp) or e.op not in _FLIP:
        return None

    def bare_build(x):
        return isinstance(x, E.BoundRef) and x.index >= nprobe

    def probe_only(x):
        return all(i < nprobe for i in _refs(x))

    if bare_build(e.left) and probe_only(e.right):
        op, bref, pexpr = e.op, e.left, e.right
    elif bare_build(e.right) and probe_only(e.left):
        op, bref, pexpr = _FLIP[e.op], e.right, e.left
    else:
        return None
    if not (_int_like(bref.ref_dtype) and _int_like(pexpr.dtype)):
        return None
    return op, bref.index - nprobe, pexpr


def _dense_minmax(bkey: torch.Tensor, bvalid: torch.Tensor, bpay: torch.Tensor,
                  pkey: torch.Tensor, key_range, pay_range
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(any, min, max) of the payload over each probe row's key among the
    valid build rows (``bvalid`` has the payload's validity folded in): the
    payload biased by its range's minimum into an int32 in [0, 2^31 - 4],
    one ``amin`` and one ``amax`` scatter into span + 1 slots (slot ``span``
    sinks the rest; an empty slot keeps 2^31 - 2) and one gather each."""
    lo = int(key_range[0])
    span = int(key_range[1]) - lo + 1
    clo = int(pay_range[0])
    dev = bkey.device
    bk = bkey.long() - lo
    bslot = torch.where(bvalid & (bk >= 0) & (bk < span), bk, span)
    enc = (bpay.long() - clo).clamp(0, _BIAS_MAX).int()
    tmin = torch.full((span + 1,), _EMPTY, dtype=torch.int32, device=dev).scatter_reduce_(
        0, bslot, enc, "amin")
    tmax = torch.full((span + 1,), -1, dtype=torch.int32, device=dev).scatter_reduce_(
        0, bslot, enc, "amax")
    pk = pkey.long() - lo
    in_rng = (pk >= 0) & (pk < span)
    slot = torch.where(in_rng, pk, span)
    mi = tmin[slot]
    return (mi != _EMPTY) & in_rng, mi.long() + clo, tmax[slot].long() + clo


def _sorted_minmax(bkey: torch.Tensor, bvalid: torch.Tensor, bpay: torch.Tensor,
                   bpay_valid: torch.Tensor, pkey: torch.Tensor, pvalid: torch.Tensor,
                   sb=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(any, min, max) of the payload over each probe row's run of equal
    keys in the sorted build: each run's min and max over its rows with a
    valid payload (one ``amin`` and one ``amax`` scatter by run), read at
    the probe row's run start. ``any``: the run has such a row. ``sb``: the
    sorted build, where made already."""
    sb = sb or _sorted_build(bkey, bvalid)
    bperm, sorted_key, _ = sb
    bcap = bkey.shape[0]
    dev = bkey.device
    live = (bpay_valid & bvalid)[bperm]
    new_run = torch.ones(bcap, dtype=torch.bool, device=dev)
    new_run[1:] = sorted_key[1:] != sorted_key[:-1]
    run = new_run.long().cumsum(0) - 1
    pay = bpay.long()[bperm]
    rmin = torch.full((bcap,), _I64_MAX, dtype=torch.int64, device=dev).scatter_reduce_(
        0, run, torch.where(live, pay, _I64_MAX), "amin")
    rmax = torch.full((bcap,), _I64_MIN, dtype=torch.int64, device=dev).scatter_reduce_(
        0, run, torch.where(live, pay, _I64_MIN), "amax")
    rany = torch.zeros(bcap, dtype=torch.int32, device=dev).index_add_(0, run, live.int()) > 0
    _, lo, count = _sorted_matches(bkey, bvalid, pkey, pvalid, sb)
    r = run[lo.clamp(0, max(bcap - 1, 0))]
    return rany[r] & (count > 0), rmin[r], rmax[r]


def _sorted_unique(bkey: torch.Tensor, bvalid: torch.Tensor, pkey: torch.Tensor,
                   pvalid: torch.Tensor, sb=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(build row of each probe row, matched, duplicate flag) on the sorted
    build: each probe row takes the first row of its run; two equal valid
    keys next to each other in the sorted build are a duplicate."""
    sb = sb or _sorted_build(bkey, bvalid)
    bperm, sorted_key, n_build = sb
    vs = torch.arange(bkey.shape[0], device=bkey.device) < n_build
    dup = ((sorted_key[1:] == sorted_key[:-1]) & vs[1:]).any()
    _, lo, count = _sorted_matches(bkey, bvalid, pkey, pvalid, sb)
    return bperm[lo.clamp(0, max(bkey.shape[0] - 1, 0))], count > 0, dup


def _pair_list(bperm: torch.Tensor, lo: torch.Tensor, count: torch.Tensor, rows: int,
               slots: Optional[torch.Tensor] = None):
    """(probe row, build row, offset into the probe row's run, live slot and
    pair of each of ``rows`` slots, overflow): probe row p owns the slots
    [off[p], off[p] + slots[p]), off the exclusive cumulative sum of
    ``slots`` (the match counts, or an outer join's counts with at least one
    slot per live probe row); a slot finds its probe row as the first whose
    inclusive sum passes it, and its build row at its offset into the probe
    row's run. A slot is a pair where its offset is under the match count."""
    n = count if slots is None else slots
    csum = n.long().cumsum(0)
    total = csum[-1] if csum.shape[0] else csum.new_zeros(())
    slot = torch.arange(rows, device=count.device)
    p = torch.searchsorted(csum, slot, right=True).clamp(max=max(count.shape[0] - 1, 0))
    j = slot - (csum[p] - n[p])
    b = bperm[(lo[p] + j).clamp(0, max(bperm.shape[0] - 1, 0))]
    live = slot < total
    return p, b, j, live, live if slots is None else live & (j < count[p]), total > rows


def _pair_block(bperm: torch.Tensor, lo: torch.Tensor, count: torch.Tensor, K: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(build row, liveness and offset j of each (probe x K) block row): row
    p*K + j is probe row p's j-th match."""
    pcap = count.shape[0]
    j = torch.arange(K, device=count.device).repeat(pcap)
    live = j < count.clamp(max=K).repeat_interleave(K)
    return bperm[(lo.repeat_interleave(K) + j).clamp(0, max(bperm.shape[0] - 1, 0))], live, j


def hash_join(left: Batch, right: Batch, left_keys: Sequence[E.Expr],
              right_keys: Sequence[E.Expr], join_type: str, build_side: str,
              out_schema: T.Schema, condition: Optional[E.Expr] = None,
              max_build_matches: int = 4, ctx: Optional[EvalContext] = None,
              build_key_range: Optional[Tuple[int, int]] = None, unique_build: bool = False,
              key_pack: Optional[Tuple[Tuple[int, int], ...]] = None,
              compact_rows: Optional[int] = None,
              dense_range: Optional[Tuple[int, int]] = None,
              cond_col_ranges: Optional[dict] = None,
              presorted_build: bool = False) -> Tuple[Batch, torch.Tensor]:
    """Returns (joined batch, overflow flag). INNER: the pairs on the path
    the arguments select (module docstring), and the flag set where the
    result is incomplete (a probe row with more than K =
    ``max_build_matches`` matches in the block, more pairs than
    ``compact_rows``, a repeated key under ``unique_build``, a key outside
    ``key_pack``), so the caller must re-run with larger capacities and no
    hints. LEFT, RIGHT and FULL (the outer side the probe side, else
    NotImplementedError, as in the JAX package): INNER's pairs on the same
    paths, plus each unmatched live probe row once with a null build side,
    and for FULL a tail of the unmatched build rows (``_outer_rows``); the
    compacted list gives every live probe row at least one slot. Semi-like:
    the probe's columns at its capacity (EXISTENCE adds ``exists``), and a
    flag set only by ``key_pack``, or with a condition on the pairs path by
    INNER's flags.
    ``build_key_range``: the exact (min, max) of a single build key, which
    lets a semi-like join use the membership bitmap (with a condition, the
    dense min/max table) and a unique build the dense table;
    ``dense_range``, a runtime filter's exact key range, takes its place for
    the semi-like bitmap (JAX ``join.py:429``); ``cond_col_ranges``: the
    exact (min, max) of the condition's columns by name;
    ``presorted_build``: the build rows come sorted ascending on the keys,
    nulls and dead rows last (the merge path, module docstring). Each run
    but a semi-like one without a condition appends its type, arguments,
    path, output capacity and whether it merged to ``ctx.join_log`` where
    that is a list."""
    semi = join_type in SEMI_LIKE
    outer = join_type in OUTER
    if join_type != JoinType.INNER and not semi and not outer:
        raise NotImplementedError(f"{join_type} joins are not ported yet")
    if join_type in (JoinType.LEFT, JoinType.RIGHT) and (
            (join_type == JoinType.LEFT) != (build_side != "left")):
        raise NotImplementedError(
            "outer side must be the probe side; planner must pick build side accordingly")
    ctx = ctx or EvalContext()
    if build_side == "left":
        assert not semi, "semi and anti joins keep the left (probe) side"
        build, probe, build_keys, probe_keys = left, right, left_keys, right_keys
    else:
        build, probe, build_keys, probe_keys = right, left, right_keys, left_keys
    K = max_build_matches
    pcap, dev = probe.capacity, probe.device

    bcols, pcols = _harmonize_keys([evaluate(k, build, ctx) for k in build_keys],
                                   [evaluate(k, probe, ctx) for k in probe_keys])
    pack_oor = None
    if _packable(bcols + pcols, key_pack):
        bkey, bvalid, boor = _pack(bcols, key_pack)
        pkey, pvalid, poor = _pack(pcols, key_pack)
        pack_oor = (boor & build.row_mask).any() | (poor & probe.row_mask).any()
        blimbs, plimbs = [bkey], [pkey]
    else:
        blimbs, bvalid = _key_limbs(bcols)
        plimbs, pvalid = _key_limbs(pcols)
    # NOT IN: a live build row with a null key lets no probe row pass
    build_null = ((build.row_mask & ~bvalid).any()
                  if join_type == JoinType.LEFT_ANTI_NULL_AWARE else None)
    bvalid = bvalid & build.row_mask
    # the merge path: one monotone search key (module docstring)
    merge = presorted_build and len(bcols) == 1 and _merge_ok(bcols[0])

    def sorted_build(bkey):
        return _sorted_build(bkey, bvalid, merge)
    pvalid = pvalid & probe.row_mask
    # a semi-like join's flag: only a packed key out of its range raises it
    semi_flag = (pack_oor if pack_oor is not None
                 else torch.zeros((), dtype=torch.bool, device=dev))

    rng = dense_range if dense_range is not None else build_key_range

    def semi_out(hit, path=None):
        """The probe batch, thinned (SEMI, ANTI) or with ``exists``; a
        join with a condition logged as it ran."""
        if join_type == JoinType.LEFT_SEMI:
            out = Batch(probe.columns, probe.row_mask & hit, out_schema)
        elif join_type == JoinType.LEFT_ANTI:
            out = Batch(probe.columns, probe.row_mask & ~hit, out_schema)
        elif join_type == JoinType.LEFT_ANTI_NULL_AWARE:
            out = Batch(probe.columns, probe.row_mask & ~hit & pvalid & ~build_null, out_schema)
        else:
            exists = ColumnVector(hit, torch.ones(pcap, dtype=torch.bool, device=dev), None,
                                  T.BOOL)
            out = Batch(tuple(probe.columns) + (exists,), probe.row_mask, out_schema)
        if path is not None:
            hash_join.semi_paths[path] += 1
            if ctx.join_log is not None:
                ctx.join_log.append({"type": join_type, "build": build_side, "K": K,
                                     "unique": unique_build, "pack": pack_oor is not None,
                                     "compact_rows": compact_rows, "path": path,
                                     "out_capacity": out.capacity, "merge": merge})
        return out

    fast = None
    if semi and condition is not None and build_side != "left" and not unique_build:
        fast = _semi_cond_decompose(condition, len(probe.schema.fields))
    if fast is not None:
        op, bi, pexpr = fast
        bcv, pcv = build.columns[bi], evaluate(pexpr, probe, ctx)
        if not bcv.is_dict and not pcv.is_dict:
            crng = (cond_col_ranges or {}).get(build.schema.fields[bi].name)
            if (_bitmap_ok(bcols, pcols, rng) and crng is not None
                    and 0 <= int(crng[1]) - int(crng[0]) < _EMPTY and bcv.data.dim() == 1):
                path = "minmax_dense"
                anyv, minv, maxv = _dense_minmax(bcols[0].data, bvalid & bcv.validity,
                                                 bcv.data, pcols[0].data, rng, crng)
            else:
                path = "minmax_sorted"
                bkey, pkey = _one_limb(blimbs, plimbs)
                anyv, minv, maxv = _sorted_minmax(bkey, bvalid, bcv.data, bcv.validity, pkey,
                                                  pvalid, sorted_build(bkey))
            pe = pcv.data.long()
            if op == "ne":
                exists = (minv != pe) | (maxv != pe)
            else:  # lt and le hold for some row where they hold for the min
                exists = _CMP[op](minv if op in ("lt", "le") else maxv, pe)
            return semi_out(pvalid & pcv.validity & anyv & exists, path), semi_flag

    if semi and condition is None:
        if _bitmap_ok(bcols, pcols, rng):
            hash_join.semi_paths["bitmap"] += 1
            hit = _bitmap_member(bcols[0].data, bvalid, pcols[0].data, pvalid, rng)
        else:
            hash_join.semi_paths["sorted"] += 1
            bkey, pkey = _one_limb(blimbs, plimbs)
            hit = _sorted_matches(bkey, bvalid, pkey, pvalid, sorted_build(bkey))[2] > 0
        if merge and ctx.join_log is not None:
            ctx.join_log.append({"type": join_type, "build": build_side, "path": "sorted",
                                 "merge": True})
        return semi_out(hit), semi_flag

    bkey, pkey = _one_limb(blimbs, plimbs)
    # j: each pair row's offset into its probe row's matches (None on the
    # unique paths, whose one row a probe row is its first); per_probe
    # spreads a probe-row flag to the pair rows, any_pair folds a pair flag
    # back to the probe rows
    j = None
    if unique_build:
        if _bitmap_ok(bcols, pcols, build_key_range):
            path = "dense_unique"
            b_idx, pair_valid, overflow = _dense_unique(bcols[0].data, bvalid, pcols[0].data,
                                                        pvalid, build_key_range)
        else:
            path = "sorted_unique"
            b_idx, pair_valid, overflow = _sorted_unique(bkey, bvalid, pkey, pvalid,
                                                         sorted_build(bkey))
        has_match = pair_valid
        probe_cols = list(probe.columns)
        per_probe = (lambda x: x)
        any_pair = (lambda v: v)
    else:
        bperm, lo, count = _sorted_matches(bkey, bvalid, pkey, pvalid, sorted_build(bkey))
        has_match = count > 0
        if compact_rows is not None:
            path = "pair_list"
            # an outer join's live probe row holds a slot even with no match
            slots = torch.where(probe.row_mask, count.clamp(min=1), count) if outer else None
            p_idx, b_idx, j, slot_live, pair_valid, overflow = _pair_list(
                bperm, lo, count, compact_rows, slots)
            ctx.join_need = ("rows", (count if slots is None else slots).sum())
            probe_cols = [c.take(p_idx) for c in probe.columns]
            per_probe = (lambda x: x[p_idx] & slot_live)
            any_pair = (lambda v: torch.zeros(pcap, dtype=torch.int32, device=dev).index_add_(
                0, p_idx, v.int()) > 0)
        else:
            path = "block"
            b_idx, pair_valid, j = _pair_block(bperm, lo, count, K)
            overflow = (count > K).any()
            ctx.join_need = ("K", count.max() if count.numel() else count.new_zeros(()))
            probe_cols = [_repeat(c, K) for c in probe.columns]
            per_probe = (lambda x: x.repeat_interleave(K))
            any_pair = (lambda v: v.view(pcap, K).any(1))
    build_cols = [c.take(b_idx) for c in build.columns]

    def assemble(pcols, bcols_):
        return bcols_ + pcols if build_side == "left" else pcols + bcols_

    if condition is not None:
        fields = assemble(list(probe.schema.fields), list(build.schema.fields))
        pair = Batch(tuple(assemble(probe_cols, build_cols)), pair_valid, T.Schema(fields))
        pair_valid = evaluate_predicate(condition, pair, ctx)
        if outer or semi:  # a probe row matches where a pair of it passes the condition
            has_match = any_pair(pair_valid)
    if pack_oor is not None:
        overflow = overflow | pack_oor
    if semi:  # a condition the min/max pushdown does not take
        return semi_out(has_match, "pairs"), overflow
    if not outer:
        out = Batch(tuple(assemble(probe_cols, build_cols)), pair_valid, out_schema)
    else:
        out = _outer_rows(join_type, probe, build, probe_cols, build_cols, b_idx, pair_valid,
                          has_match, per_probe, j, assemble, out_schema)
    if ctx.join_log is not None:
        ctx.join_log.append({"type": join_type, "build": build_side, "K": K,
                             "unique": unique_build, "pack": pack_oor is not None,
                             "compact_rows": compact_rows, "path": path,
                             "out_capacity": out.capacity,
                             "merge": merge and path != "dense_unique"})
    return out, overflow


def _outer_rows(join_type, probe: Batch, build: Batch, probe_cols, build_cols, b_idx,
                pair_valid, has_match, per_probe, j, assemble, out_schema) -> Batch:
    """LEFT and RIGHT: the pairs, and each live probe row with no pair once,
    in its first slot (j = 0), with a null build side (JAX ``join.py:704``).
    FULL: that, then a build-capacity tail holding the build rows no pair
    matched, with a null probe side (``:719``)."""
    un_slot = per_probe(probe.row_mask & ~has_match)
    if j is not None:
        un_slot = un_slot & (j == 0)
    build_cols = [c.with_validity(c.validity & ~un_slot) for c in build_cols]
    out_cols = assemble(probe_cols, build_cols)
    if join_type != JoinType.FULL:
        return Batch(tuple(out_cols), pair_valid | un_slot, out_schema)
    bcap = build.capacity
    hit = torch.zeros(bcap, dtype=torch.int32, device=build.device).index_add_(
        0, b_idx, pair_valid.int())
    tail = assemble([_null_like(c, bcap) for c in probe.columns], list(build.columns))
    out_cols = [_concat_column([c, t], c.dtype) for c, t in zip(out_cols, tail)]
    return Batch(tuple(out_cols), torch.cat([pair_valid | un_slot, build.row_mask & (hit == 0)]),
                 out_schema)


# the semi-like joins run by each membership path, counted where they run
hash_join.semi_paths = {"bitmap": 0, "sorted": 0, "minmax_dense": 0, "minmax_sorted": 0,
                        "pairs": 0}


def _null_like(cv: ColumnVector, cap: int) -> ColumnVector:
    """``cap`` null rows of ``cv``'s type, storage and dictionary."""
    return map_buffers(cv, lambda a: a.new_zeros((cap,) + tuple(a.shape[1:])))


# The JAX package's comet.exec.bnlj.maxProductRows default: a nested-loop
# join whose left capacity times right capacity is over this many pair rows
# raises MemoryError instead of allocating them.
BNLJ_MAX_PRODUCT_ROWS = 1 << 26


def nested_loop_join(left: Batch, right: Batch, join_type: str, out_schema: T.Schema,
                     condition: Optional[E.Expr] = None,
                     ctx: Optional[EvalContext] = None) -> Batch:
    """Broadcast nested-loop join (JAX ``join.py:778-830``): the full cross
    product, pair row l * cap_r + r holding left row l and right row r,
    under the condition's mask (every live pair without one). INNER keeps
    the pairs that pass; LEFT adds each left row with no passing pair once,
    in its r = 0 slot, with a null right side; RIGHT mirrors it in the l = 0
    slot; FULL is LEFT's block and a tail of cap_r rows holding the
    unmatched right rows with a null left side; LEFT_SEMI and LEFT_ANTI keep
    the left batch with the rows that have (have no) passing pair. A
    product over ``BNLJ_MAX_PRODUCT_ROWS`` raises MemoryError."""
    lcap, rcap = left.capacity, right.capacity
    if lcap * rcap > BNLJ_MAX_PRODUCT_ROWS:
        raise MemoryError(
            f"BNLJ cross product {lcap} x {rcap} rows exceeds "
            f"comet.exec.bnlj.maxProductRows={BNLJ_MAX_PRODUCT_ROWS}; add equi-join keys or "
            f"filter the broadcast side")
    ctx = ctx or EvalContext()
    dev = left.device
    li = torch.arange(lcap, device=dev).repeat_interleave(rcap)
    ri = torch.arange(rcap, device=dev).repeat(lcap)
    lcols = [c.take(li) for c in left.columns]
    rcols = [c.take(ri) for c in right.columns]
    pair_live = left.row_mask[li] & right.row_mask[ri]
    pair = Batch(tuple(lcols) + tuple(rcols), pair_live,
                 T.Schema(list(left.schema.fields) + list(right.schema.fields)))
    cmask = evaluate_predicate(condition, pair, ctx) if condition is not None else pair_live
    grid = cmask.view(lcap, rcap)
    if join_type == JoinType.INNER:
        return Batch(pair.columns, cmask, out_schema)
    if join_type in (JoinType.LEFT, JoinType.FULL):
        un_l_slot = (ri == 0) & (left.row_mask & ~grid.any(1))[li]
        rcols = [c.with_validity(c.validity & ~un_l_slot) for c in rcols]
        if join_type == JoinType.LEFT:
            return Batch(tuple(lcols) + tuple(rcols), cmask | un_l_slot, out_schema)
        # FULL: the unmatched right rows follow in a tail of their own
        lcols = [_concat_column([c, _null_like(c, rcap)], c.dtype) for c in lcols]
        rcols = [_concat_column([c, rc], c.dtype) for c, rc in zip(rcols, right.columns)]
        live = torch.cat([cmask | un_l_slot, right.row_mask & ~grid.any(0)])
        return Batch(tuple(lcols) + tuple(rcols), live, out_schema)
    if join_type == JoinType.LEFT_SEMI:
        return Batch(left.columns, left.row_mask & grid.any(1), out_schema)
    if join_type == JoinType.LEFT_ANTI:
        return Batch(left.columns, left.row_mask & ~grid.any(1), out_schema)
    if join_type == JoinType.RIGHT:
        un_slot = (li == 0) & (right.row_mask & ~grid.any(0))[ri]
        lcols = [c.with_validity(c.validity & ~un_slot) for c in lcols]
        return Batch(tuple(lcols) + tuple(rcols), cmask | un_slot, out_schema)
    raise NotImplementedError(f"nested loop join type {join_type}")
