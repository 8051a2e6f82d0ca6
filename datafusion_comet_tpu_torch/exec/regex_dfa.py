"""Regex -> DFA compiler and vectorized matcher for RLIKE (port of
``datafusion_comet_tpu/exec/regex_dfa.py``).

The pattern is a plan literal, compiled on the host into a byte-level DFA
(Thompson NFA, then subset construction); the parser and the compiler are
the JAX module's, unchanged (numpy only). Search ("find anywhere")
semantics are folded in at NFA build time: the input is framed as
``BOS bytes EOS`` (two virtual symbols, alphabet 258), anchors compile to
atoms over BOS/EOS, and the pattern is wrapped as ``BOS? S* p S* EOS?``, so
a row matches where the state after BOS, its live bytes and EOS accepts.

Supported syntax: literals (UTF-8 bytes), ``.``, ``[...]`` classes with
ranges and negation, ``* + ? {m} {m,} {m,n}``, alternation, groups,
``\\d \\w \\s`` and their complements, ``^ $``. ``.`` matches any byte but
``\\n`` (Java's default); classes act per byte, not per code point.

Matching (``dfa_match``): one gather into the flattened (S x 258)
transition table per byte column, for every automaton. The JAX package
lowers automata of at most 64 states and 24 byte classes to a tree of
selects instead, because a gather costs about 180 ms per 8M rows on a TPU;
on a GPU the select tree would be S x C launches per byte column. The two
lowerings give the same states, so the same answers.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, FrozenSet, List, Set, Tuple

import numpy as np
import torch

__all__ = ["compile_dfa", "dfa_match"]

_ALL = frozenset(range(256))  # real bytes only — excludes BOS/EOS
_DOT = frozenset(b for b in range(256) if b != 0x0A)
_BOS = 256  # virtual begin-of-string symbol (consumed by ^)
_EOS = 257  # virtual end-of-string symbol (consumed by $)
_NSYM = 258
_DIGIT = frozenset(range(ord("0"), ord("9") + 1))
_WORD = frozenset(
    list(range(ord("a"), ord("z") + 1))
    + list(range(ord("A"), ord("Z") + 1))
    + list(range(ord("0"), ord("9") + 1))
    + [ord("_")]
)
_SPACE = frozenset(b" \t\n\r\x0b\x0c")


# -------------------------------------------------------------------------------------
# parser: pattern → AST
# -------------------------------------------------------------------------------------
# AST nodes: ("char", frozenset) | ("cat", [..]) | ("alt", [..]) |
#            ("star", node) | ("plus", node) | ("opt", node) | ("empty",)


class _Parser:
    def __init__(self, pat: str):
        self.b = pat.encode("utf-8")
        self.i = 0

    def peek(self):
        return self.b[self.i] if self.i < len(self.b) else None

    def eat(self):
        c = self.b[self.i]
        self.i += 1
        return c

    def parse(self):
        node = self._alt()
        if self.i != len(self.b):
            raise ValueError(f"unexpected {chr(self.b[self.i])!r} at {self.i}")
        return node

    def _alt(self):
        parts = [self._cat()]
        while self.peek() == ord("|"):
            self.eat()
            parts.append(self._cat())
        return parts[0] if len(parts) == 1 else ("alt", parts)

    def _cat(self):
        parts = []
        while self.peek() is not None and self.peek() not in (ord("|"), ord(")")):
            parts.append(self._repeat())
        if not parts:
            return ("empty",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _repeat(self):
        node = self._atom()
        while self.peek() in (ord("*"), ord("+"), ord("?"), ord("{")):
            c = self.peek()
            if c == ord("{"):
                save = self.i
                rep = self._try_braces()
                if rep is None:
                    self.i = save
                    break
                m, n = rep
                node = self._expand_braces(node, m, n)
            else:
                self.eat()
                node = {ord("*"): ("star", node), ord("+"): ("plus", node), ord("?"): ("opt", node)}[c]
        return node

    def _try_braces(self):
        self.eat()  # {
        digs = bytearray()
        while self.peek() is not None and chr(self.peek()).isdigit():
            digs.append(self.eat())
        if not digs:
            return None
        m = int(digs.decode())
        if self.peek() == ord("}"):
            self.eat()
            return (m, m)
        if self.peek() != ord(","):
            return None
        self.eat()
        digs2 = bytearray()
        while self.peek() is not None and chr(self.peek()).isdigit():
            digs2.append(self.eat())
        if self.peek() != ord("}"):
            return None
        self.eat()
        n = int(digs2.decode()) if digs2 else None
        return (m, n)

    def _expand_braces(self, node, m: int, n):
        parts = [node] * m
        if n is None:
            parts.append(("star", node))
        else:
            if n > 64:
                raise ValueError("repetition bound too large")
            parts += [("opt", node)] * (n - m)
        if not parts:
            return ("empty",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _atom(self):
        c = self.eat()
        if c == ord("^"):
            return ("char", frozenset([_BOS]))
        if c == ord("$"):
            return ("char", frozenset([_EOS]))
        if c == ord("("):
            # swallow non-capturing / capturing markers
            if self.peek() == ord("?"):
                self.eat()
                if self.peek() in (ord(":"), ord("i")):  # (?: or (?i — flags ignored
                    self.eat()
            node = self._alt()
            if self.peek() != ord(")"):
                raise ValueError("unbalanced (")
            self.eat()
            return node
        if c == ord("["):
            return ("char", self._char_class())
        if c == ord("."):
            return ("char", _DOT)
        if c == ord("\\"):
            return ("char", self._escape(self.eat()))
        return ("char", frozenset([c]))

    def _escape(self, c: int) -> FrozenSet[int]:
        m = {
            ord("d"): _DIGIT,
            ord("D"): _ALL - _DIGIT,
            ord("w"): _WORD,
            ord("W"): _ALL - _WORD,
            ord("s"): _SPACE,
            ord("S"): _ALL - _SPACE,
            ord("n"): frozenset([0x0A]),
            ord("t"): frozenset([0x09]),
            ord("r"): frozenset([0x0D]),
        }
        return m.get(c, frozenset([c]))

    def _char_class(self) -> FrozenSet[int]:
        neg = False
        if self.peek() == ord("^"):
            neg = True
            self.eat()
        out: Set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise ValueError("unbalanced [")
            if c == ord("]") and not first:
                self.eat()
                break
            first = False
            c = self.eat()
            if c == ord("\\"):
                out |= self._escape(self.eat())
                continue
            if self.peek() == ord("-") and self.i + 1 < len(self.b) and self.b[self.i + 1] != ord("]"):
                self.eat()  # -
                hi = self.eat()
                if hi == ord("\\"):
                    hi = self.eat()
                out |= set(range(c, hi + 1))
            else:
                out.add(c)
        return frozenset(_ALL - out) if neg else frozenset(out)


# -------------------------------------------------------------------------------------
# NFA (Thompson) → DFA (subset construction)
# -------------------------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.eps: List[Set[int]] = []  # state → epsilon successors
        self.trans: List[List[Tuple[FrozenSet[int], int]]] = []  # state → [(bytes, next)]

    def new_state(self) -> int:
        self.eps.append(set())
        self.trans.append([])
        return len(self.eps) - 1

    def add(self, node) -> Tuple[int, int]:
        """Build fragment; returns (start, end)."""
        kind = node[0]
        if kind == "empty":
            s = self.new_state()
            return s, s
        if kind == "char":
            s, e = self.new_state(), self.new_state()
            self.trans[s].append((node[1], e))
            return s, e
        if kind == "cat":
            first = prev_end = None
            for child in node[1]:
                cs, ce = self.add(child)
                if first is None:
                    first = cs
                else:
                    self.eps[prev_end].add(cs)
                prev_end = ce
            return first, prev_end
        if kind == "alt":
            s, e = self.new_state(), self.new_state()
            for child in node[1]:
                cs, ce = self.add(child)
                self.eps[s].add(cs)
                self.eps[ce].add(e)
            return s, e
        if kind in ("star", "opt", "plus"):
            cs, ce = self.add(node[1])
            s, e = self.new_state(), self.new_state()
            self.eps[s].add(cs)
            if kind != "plus":
                self.eps[s].add(e)
            self.eps[ce].add(e)
            if kind != "opt":
                self.eps[ce].add(cs)
            return s, e
        raise AssertionError(kind)

    def eclose(self, states: FrozenSet[int]) -> FrozenSet[int]:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in self.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)


@lru_cache(maxsize=512)
def compile_dfa(pattern: str) -> Tuple[np.ndarray, np.ndarray]:
    """Compile a regex into (trans (S,258) int32, accepting (S,) bool) with
    search semantics folded in: BOS? Σ* p Σ* EOS? over BOS+bytes+EOS input."""
    ast = _Parser(pattern).parse()
    sigma_star = ("star", ("char", _ALL))
    full = ("cat", [
        ("opt", ("char", frozenset([_BOS]))),
        sigma_star,
        ast,
        sigma_star,
        ("opt", ("char", frozenset([_EOS]))),
    ])

    nfa = _NFA()
    start, end = nfa.add(full)

    # subset construction over the 258-symbol alphabet, grouped by classes
    # of bytes that behave identically (keeps the work proportional to the
    # of symbols behaving identically, expanded back to the full-width table)
    start_set = nfa.eclose(frozenset([start]))
    dfa_index: Dict[FrozenSet[int], int] = {start_set: 0}
    order = [start_set]
    rows: List[Dict[int, int]] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        # collect outgoing byte→target-set
        byte_targets: Dict[int, Set[int]] = {}
        for s in cur:
            for bytes_set, nxt in nfa.trans[s]:
                for bb in bytes_set:
                    byte_targets.setdefault(bb, set()).add(nxt)
        row: Dict[int, int] = {}
        # group bytes by identical target sets to close each set once
        groups: Dict[FrozenSet[int], List[int]] = {}
        for bb, tgt in byte_targets.items():
            groups.setdefault(frozenset(tgt), []).append(bb)
        for tgt, bbs in groups.items():
            closed = nfa.eclose(tgt)
            if closed not in dfa_index:
                dfa_index[closed] = len(order)
                order.append(closed)
            for bb in bbs:
                row[bb] = dfa_index[closed]
        rows.append(row)
        if len(order) > 4096:
            raise ValueError("regex DFA too large")

    S = len(order) + 1  # extra dead state at index S-1
    dead = S - 1
    trans = np.full((S, _NSYM), dead, np.int32)
    for si, row in enumerate(rows):
        for bb, tgt in row.items():
            trans[si, bb] = tgt
    accepting = np.zeros(S, bool)
    for st, si in dfa_index.items():
        if end in st:
            accepting[si] = True
    return trans, accepting


def _byte_classes(trans: np.ndarray):
    """Group the 256 byte symbols into equivalence classes (identical
    transition columns). Returns (class_of_byte uint8[256], class_reps list,
    n_classes). Patterns touch few distinct byte behaviors, so C is tiny."""
    cols = {}
    class_of = np.zeros(256, np.int32)
    reps = []
    for b in range(256):
        key = trans[:, b].tobytes()
        if key not in cols:
            cols[key] = len(reps)
            reps.append(b)
        class_of[b] = cols[key]
    return class_of, reps, len(reps)


def dfa_match(mat: torch.Tensor, lens: torch.Tensor, trans: np.ndarray,
              accepting: np.ndarray) -> torch.Tensor:
    """(rows,) bool: the DFA run over BOS, each row's live bytes (the
    first ``lens`` of its (rows, w) uint8 row) and EOS accepts."""
    dev = mat.device
    cap, L = mat.shape
    t = torch.from_numpy(trans.reshape(-1).astype(np.int64)).to(dev)
    acc = torch.from_numpy(accepting).to(dev)
    # consume BOS from the start state
    state = t[_BOS].expand(cap).clone()
    for j in range(L):
        nxt = t[state * _NSYM + mat[:, j].long()]
        state = torch.where(j < lens, nxt, state)
    return acc[t[state * _NSYM + _EOS]]
