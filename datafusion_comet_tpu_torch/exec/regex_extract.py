"""Device regexp_extract, regexp_extract_all and regexp_replace for linear
(backtracking-free) patterns (port of
``datafusion_comet_tpu/exec/regex_extract.py``).

Spark's contract (java.util.regex): the leftmost match, greedy
quantifiers, group ``idx``'s bytes, "" where nothing matches or the group
did not take part. A pattern that is one concatenation of literal runs and
class repeats (each optionally inside one level of capture group) runs as
a position chain: a run-length table per character class (one reverse
cummax each), then one gather per segment advances every candidate start
at once. Greedy per segment equals java.util.regex where no backtracking
can happen, which ``linearize`` guarantees by refusing a variable segment
whose class meets the first bytes of a following required segment; such
patterns, alternations and nested or repeated groups take the host bridge
(ir/functions.py). The pattern parser is the JAX module's, unchanged.

Rows run in tiles (the JAX package's ``lax.map`` tiles, the same sizes)
so the (rows x width) position tables stay bounded in memory.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from datafusion_comet_tpu_torch.exec.regex_dfa import _ALL, _DIGIT, _DOT, _SPACE, _WORD

__all__ = ["linearize", "min_match_len", "extract_device", "extract_all_device",
           "replace_device"]


@dataclasses.dataclass(frozen=True)
class Seg:
    charset: Optional[FrozenSet[int]]  # None => literal
    lit: Optional[bytes]
    mn: int
    mx: Optional[int]  # None = unbounded
    group: Optional[int]  # enclosing single-level group id (1-based)

    @property
    def variable(self) -> bool:
        return self.mx is None or self.mx > self.mn


@dataclasses.dataclass(frozen=True)
class LinearPattern:
    segs: Tuple[Seg, ...]
    anchored_start: bool
    anchored_end: bool
    n_groups: int


class _Reject(Exception):
    pass


def _parse(pattern: str) -> LinearPattern:
    b = pattern.encode("utf-8")
    i = 0
    segs: List[Seg] = []
    group = None
    n_groups = 0
    anchored_start = False
    anchored_end = False

    def atom() -> Tuple[Optional[FrozenSet[int]], Optional[bytes]]:
        nonlocal i
        c = b[i]
        if c == ord("."):
            i += 1
            return _DOT, None
        if c == ord("["):
            i += 1
            neg = i < len(b) and b[i] == ord("^")
            if neg:
                i += 1
            out: set = set()
            first = True
            while i < len(b) and (b[i] != ord("]") or first):
                first = False
                if b[i] == ord("\\") and i + 1 < len(b):
                    out |= _escape_set(b[i + 1])
                    i += 2
                    continue
                lo = b[i]
                if i + 2 < len(b) and b[i + 1] == ord("-") and b[i + 2] != ord("]"):
                    hi = b[i + 2]
                    out |= set(range(lo, hi + 1))
                    i += 3
                else:
                    out.add(lo)
                    i += 1
            if i >= len(b):
                raise _Reject("unterminated class")
            i += 1  # ']'
            return (frozenset(_ALL - out) if neg else frozenset(out)), None
        if c == ord("\\") and i + 1 < len(b):
            nxt = b[i + 1]
            i += 2
            es = _escape_set(nxt)
            if len(es) == 1:
                return None, bytes([next(iter(es))])
            return es, None
        if c in b"(){}|*+?^$":
            raise _Reject(f"unexpected {chr(c)}")
        i += 1
        return None, bytes([c])

    def postfix() -> Optional[Tuple[int, Optional[int]]]:
        nonlocal i
        if i >= len(b):
            return None
        c = b[i]
        if c == ord("*"):
            i += 1
            return (0, None)
        if c == ord("+"):
            i += 1
            return (1, None)
        if c == ord("?"):
            i += 1
            return (0, 1)
        if c == ord("{"):
            j = b.find(b"}", i)
            if j < 0:
                raise _Reject("unterminated brace")
            body = b[i + 1 : j].decode()
            i = j + 1
            if "," in body:
                m_s, n_s = body.split(",", 1)
                mn = int(m_s) if m_s else 0
                mx = int(n_s) if n_s.strip() else None
            else:
                mn = mx = int(body)
            return (mn, mx)
        return None

    while i < len(b):
        c = b[i]
        if c == ord("^"):
            if segs or group is not None:
                raise _Reject("interior ^")
            anchored_start = True
            i += 1
            continue
        if c == ord("$"):
            if i != len(b) - 1:
                raise _Reject("interior $")
            anchored_end = True
            i += 1
            continue
        if c == ord("|"):
            raise _Reject("alternation")
        if c == ord("("):
            if group is not None:
                raise _Reject("nested group")
            if b[i : i + 3] == b"(?:":
                raise _Reject("non-capturing group")  # keep it simple
            n_groups += 1
            group = n_groups
            i += 1
            continue
        if c == ord(")"):
            if group is None:
                raise _Reject("unbalanced )")
            group = None
            i += 1
            if postfix() is not None:
                raise _Reject("repeated group")
            continue
        cs, lit = atom()
        rep = postfix()
        if rep is None:
            if lit is not None and segs and segs[-1].lit is not None \
                    and segs[-1].group == group and segs[-1].mn == segs[-1].mx == 1:
                prev = segs.pop()
                segs.append(Seg(None, prev.lit + lit, 1, 1, group))
            else:
                segs.append(Seg(cs, lit, 1, 1, group))
            continue
        mn, mx = rep
        if lit is not None:
            cs = frozenset(lit)
            lit = None
        segs.append(Seg(cs, lit, mn, mx, group))
    if group is not None:
        raise _Reject("unbalanced (")
    return LinearPattern(tuple(segs), anchored_start, anchored_end, n_groups)


def _escape_set(c: int) -> FrozenSet[int]:
    m = {
        ord("d"): _DIGIT, ord("D"): frozenset(_ALL - _DIGIT),
        ord("w"): _WORD, ord("W"): frozenset(_ALL - _WORD),
        ord("s"): _SPACE, ord("S"): frozenset(_ALL - _SPACE),
        ord("n"): frozenset({0x0A}), ord("t"): frozenset({0x09}),
        ord("r"): frozenset({0x0D}),
    }
    if c in m:
        return m[c]
    return frozenset({c})


def _first_set(seg: Seg) -> FrozenSet[int]:
    if seg.lit is not None:
        return frozenset(seg.lit[:1])
    return seg.charset or frozenset()


@lru_cache(maxsize=256)
def linearize(pattern: str, idx: int = 1) -> Optional[LinearPattern]:
    """Compile ``pattern`` for the device chain, or None when it needs the
    host bridge (unsupported syntax, possible backtracking, or group idx
    out of range)."""
    try:
        lp = _parse(pattern)
    except (_Reject, ValueError, IndexError):
        return None
    if idx > lp.n_groups:
        return None
    segs = lp.segs
    for i, s in enumerate(segs):
        if not s.variable or s.charset is None:
            continue
        # greedy-no-backtrack soundness: the charset of a variable segment
        # must be disjoint from the first bytes of every following segment
        # up to and including the first REQUIRED one
        for t in segs[i + 1:]:
            if s.charset & _first_set(t):
                return None
            if t.mn > 0:
                break
        else:
            # pattern tail all-optional: greedy eats to end — fine unless
            # the pattern is end-anchored with overlap (handled above)
            pass
    return lp


def _match_tables(mat: torch.Tensor, lens: torch.Tensor, lp: LinearPattern,
                  tabs: Dict[FrozenSet[int], torch.Tensor], idxW: torch.Tensor):
    """Per start position of one row tile: (ok (r, W): a greedy match
    starts here; start; cur: its end; gstart, gend: each group's span),
    positions int64. The core that extract and replace share."""
    r, W = mat.shape
    in_len = idxW[None, :] < lens[:, None]
    m64 = mat.long()
    runs = {}
    for cs, tab in tabs.items():
        # run of class bytes from each position: distance to the next break
        M = (tab[m64] & in_len).flip(1)
        brk = torch.where(~M, idxW[None, :], -1)
        runs[cs] = (idxW[None, :] - torch.cummax(brk, dim=1).values).flip(1)
    lits = {}
    for s in lp.segs:
        if s.lit is not None and s.lit not in lits:
            ok = torch.ones((r, W), dtype=torch.bool, device=mat.device)
            for k, byte in enumerate(s.lit):
                eq = mat == byte
                if k:  # byte k at position p + k: shift left by k
                    eq = eq[:, k:]
                    eq = torch.nn.functional.pad(eq, (0, W - eq.shape[1]))
                ok &= eq
            lits[s.lit] = ok & ((idxW[None, :] + len(s.lit)) <= lens[:, None])
    cur = idxW[None, :].expand(r, W)
    ok = cur <= lens[:, None]  # a match may start at any position <= len
    if lp.anchored_start:
        ok = ok & (cur == 0)
    start = cur
    gstart: Dict[int, torch.Tensor] = {}
    gend: Dict[int, torch.Tensor] = {}
    for s in lp.segs:
        if s.group is not None and s.group not in gstart:
            gstart[s.group] = cur
        safe = cur.clamp(0, W - 1)
        inb = cur < W
        if s.lit is not None:
            ok = ok & lits[s.lit].gather(1, safe) & inb
            cur = cur + len(s.lit)
        else:
            run = torch.where(inb, runs[s.charset].gather(1, safe), 0)
            ok = ok & (run >= s.mn)
            cur = cur + (run if s.mx is None else run.clamp(max=s.mx))
        if s.group is not None:
            gend[s.group] = cur  # overwritten until the group closes
    if lp.anchored_end:
        ok = ok & (cur == lens[:, None])
    return ok, start, cur, gstart, gend


def _charset_tables(lp: LinearPattern, dev) -> Dict[FrozenSet[int], torch.Tensor]:
    """A 256-entry membership table per distinct class of the pattern."""
    tabs: Dict[FrozenSet[int], torch.Tensor] = {}
    for s in lp.segs:
        if s.charset is not None and s.charset not in tabs:
            tabs[s.charset] = torch.tensor([b in s.charset for b in range(256)],
                                           dtype=torch.bool, device=dev)
    return tabs


def _tiles(n: int, W: int, budget: int):
    """Row slices of the JAX package's tile size."""
    tile = max(1, min(n, budget // max(W, 1)))
    return [slice(i, min(i + tile, n)) for i in range(0, n, tile)]


def _non_overlapping(ok: torch.Tensor, cur: torch.Tensor, empty_step: bool) -> torch.Tensor:
    """(r, W) bool: the candidates a left-to-right scan takes, each at or
    after the previous taken match's end (past its start where
    ``empty_step``)."""
    r, W = ok.shape
    nxt = torch.zeros(r, dtype=torch.long, device=ok.device)
    real = torch.zeros_like(ok)
    for j in range(W):
        take = ok[:, j] & (j >= nxt)
        end = cur[:, j].clamp(min=j + 1) if empty_step else cur[:, j]
        nxt = torch.where(take, end, nxt)
        real[:, j] = take
    return real


def min_match_len(lp: "LinearPattern") -> int:
    """Minimum bytes a match can span (0 = can match empty — replace
    rejects those: Java advances one char on empty matches, a semantic the
    vectorized scan doesn't model)."""
    return sum((len(s.lit) if s.lit is not None else s.mn) for s in lp.segs)


def replace_device(data: torch.Tensor, lengths: torch.Tensor, validity: torch.Tensor,
                   lp: LinearPattern, repl: bytes, out_width: int):
    """regexp_replace with a literal replacement over every non-overlapping
    leftmost greedy match: the candidates' table, a W-step scan for the
    non-overlapping ones, then the kept bytes and the replacement bytes
    scattered to their output columns (past ``out_width``: dropped).
    Returns (bytes (n, out_width), lengths, overflow (n,): the output
    outgrew ``out_width``)."""
    n, W = data.shape
    dev = data.device
    R = len(repl)
    tabs = _charset_tables(lp, dev)
    idxW = torch.arange(W, device=dev)
    outs, out_lens, ovfs = [], [], []
    for sl in _tiles(n, W, 1 << 22):
        mat, lens = data[sl], lengths[sl].long()
        r = mat.shape[0]
        ok, start, cur, _, _ = _match_tables(mat, lens, lp, tabs, idxW)
        real = _non_overlapping(ok, cur, False)
        in_len = idxW[None, :] < lens[:, None]
        # bytes inside a match are dropped: +1 at its start, -1 at its end
        inc = torch.zeros((r, W + 1), dtype=torch.int32, device=dev)
        inc.scatter_add_(1, torch.where(real, idxW[None, :], W), real.int())
        inc.scatter_add_(1, torch.where(real, cur, W).clamp(0, W), -real.int())
        kept = in_len & ~(torch.cumsum(inc[:, :W], 1) > 0)
        kept_incl = torch.cumsum(kept.long(), 1)
        real_incl = torch.cumsum(real.long(), 1)
        # one spare column takes what falls past out_width
        out = torch.zeros((r, out_width + 1), dtype=torch.uint8, device=dev)
        # kept byte j -> (#kept <= j) - 1 + R x (#matches starting <= j)
        kcol = kept_incl - 1 + R * real_incl
        out.scatter_(1, torch.where(kept, kcol, out_width).clamp(max=out_width),
                     torch.where(kept, mat, 0))
        # the replacement of the match at j -> (#kept < j) + R x (#matches < j)
        base = (kept_incl - kept.long()) + R * (real_incl - 1)
        for k in range(R):
            c = torch.where(real, base + k, out_width).clamp(max=out_width)
            out.scatter_(1, c, real.to(torch.uint8) * repl[k])
        n_out = kept.sum(1) + R * real.sum(1)
        outs.append(out[:, :out_width])
        out_lens.append(n_out.clamp(max=out_width).int())
        ovfs.append(n_out > out_width)
    return torch.cat(outs), torch.cat(out_lens), torch.cat(ovfs) & validity


def extract_all_device(data: torch.Tensor, lengths: torch.Tensor, validity: torch.Tensor,
                       lp: LinearPattern, idx: int, max_parts: int, out_width: int):
    """regexp_extract_all: group ``idx`` of every non-overlapping leftmost
    greedy match as a padded LIST<STRING> plane. Returns (counts (n,),
    element bytes (n, E, out_width), element lengths (n, E), element
    validity (n, E), overflow (n,): more than E matches)."""
    n, W = data.shape
    dev = data.device
    E_ = max_parts
    tabs = _charset_tables(lp, dev)
    idxW = torch.arange(W, device=dev)
    ms = torch.arange(E_, device=dev)
    c = torch.arange(out_width, device=dev)
    parts = []
    for sl in _tiles(n, W, 1 << 21):
        mat, lens = data[sl], lengths[sl].long()
        r = mat.shape[0]
        ok, start, cur, gstart, gend = _match_tables(mat, lens, lp, tabs, idxW)
        real = _non_overlapping(ok, cur, True)
        s_tab = (start if idx == 0 else gstart[idx]).int()
        e_tab = (cur if idx == 0 else gend[idx]).int()
        rank = torch.cumsum(real.int(), 1) - 1
        oh = real[:, None, :] & (rank[:, None, :] == ms[None, :, None])
        s_m = (oh * s_tab[:, None, :]).sum(-1)
        e_m = (oh * e_tab[:, None, :]).sum(-1)
        has = oh.any(-1)
        n_m = real.sum(1)
        flen = torch.where(has, (e_m - s_m).clamp(0, out_width), 0)
        src = (s_m[:, :, None].long() + c[None, None, :]).clamp(0, W - 1)
        got = mat[:, None, :].expand(r, E_, W).gather(2, src)
        got = torch.where(c[None, None, :] < flen[:, :, None], got, 0)
        parts.append((n_m.clamp(max=E_).int(), got.to(torch.uint8), flen.int(), has,
                      n_m > E_))
    cnt, eb, el, ev, ovf = (torch.cat([p[i] for p in parts]) for i in range(5))
    return cnt, eb, el, ev, ovf & validity


def extract_device(data: torch.Tensor, lengths: torch.Tensor, validity: torch.Tensor,
                   lp: LinearPattern, idx: int, out_width: int):
    """(n, W) bytes and lengths -> (bytes (n, out_width), lengths,
    validity) of group ``idx`` of each row's leftmost greedy match."""
    n, W = data.shape
    dev = data.device
    tabs = _charset_tables(lp, dev)
    idxW = torch.arange(W, device=dev)
    oidx = torch.arange(out_width, device=dev)
    outs, out_lens = [], []
    for sl in _tiles(n, W, 1 << 22):
        mat, lens = data[sl], lengths[sl].long()
        ok, start, cur, gstart, gend = _match_tables(mat, lens, lp, tabs, idxW)
        j_star = torch.where(ok, start, W + 1).argmin(1, keepdim=True)
        found = ok.any(1)
        s0 = (start if idx == 0 else gstart[idx]).gather(1, j_star)[:, 0]
        e0 = (cur if idx == 0 else gend[idx]).gather(1, j_star)[:, 0]
        glen = torch.where(found, (e0 - s0).clamp(0, out_width), 0)
        out = mat.gather(1, (s0[:, None] + oidx[None, :]).clamp(0, W - 1))
        outs.append(torch.where(oidx[None, :] < glen[:, None], out, 0).to(torch.uint8))
        out_lens.append(glen.int())
    return torch.cat(outs), torch.cat(out_lens), validity
