"""String functions over padded bytes (port of JAX ``evaluator.py:1741-2081``
``_string_func_impl``, ``_replace_equal_len`` and ``_levenshtein``, and of
``exec/split_device.py`` and ``exec/format_number.py``).

A string column here is a (rows, w) uint8 matrix and int32 lengths; a
dictionary column reaches these functions as the (K, w) matrix of its
entries (exec/evaluator.py ``_eval_on_dict``). Every function works column
by column over the whole matrix: a loop runs over byte positions (the
width, a static number), never over rows. Output widths are static and
come from the bound type (``ir/expr.py::_string_func_type``).

Kept from the JAX package, whatever Spark does: bytes, not characters
(upper, lower and initcap touch ASCII letters only; length counts bytes);
``replace`` with a search and a replacement of equal length only;
``translate`` maps a byte with no replacement to a zero byte.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.batch import ColumnVector
from datafusion_comet_tpu_torch.ir import expr as E

__all__ = ["string_func", "soundex", "split", "split_part", "substring_index",
           "format_number", "pad_width"]


def pad_width(mat: torch.Tensor, w: int) -> torch.Tensor:
    """Zero-pad a (rows, w0) byte matrix to w >= w0 columns."""
    return mat if mat.shape[1] == w else torch.nn.functional.pad(mat, (0, w - mat.shape[1]))


def _fit(mat: torch.Tensor, w: int) -> torch.Tensor:
    """Cut or zero-pad to width ``w``."""
    return mat[:, :w] if mat.shape[1] >= w else pad_width(mat, w)


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, device=dev)[None, :]


def _first_true(m: torch.Tensor) -> torch.Tensor:
    return m.to(torch.uint8).argmax(1)


def _last_true(m: torch.Tensor) -> torch.Tensor:
    return m.shape[1] - 1 - m.flip(1).to(torch.uint8).argmax(1)


def _gather(mat: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Row-wise gather of byte positions ``src`` (clamped into the width)."""
    w = mat.shape[1]
    if w == 0:
        return torch.zeros(src.shape, dtype=mat.dtype, device=mat.device)
    return mat.gather(1, src.clamp(0, w - 1).expand(mat.shape[0], -1))


def _keep(data: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Zero the bytes at and past each row's length ``n``."""
    pos = _arange(data.shape[1], data.device)
    return torch.where(pos < n[:, None], data, torch.zeros((), dtype=data.dtype,
                                                           device=data.device))


def _match_starts(smat: torch.Tensor, slens: torch.Tensor, pat: ColumnVector) -> torch.Tensor:
    """(rows, sw) bool: the pattern (a column) starts at each position and
    fits in the string."""
    cap, sw = smat.shape
    base = torch.arange(sw, device=smat.device)
    acc = torch.ones((cap, sw), dtype=torch.bool, device=smat.device)
    for j in range(pat.data.shape[1]):
        chars = smat[:, (base + j).clamp(max=max(sw - 1, 0))]
        acc &= (chars == pat.data[:, j][:, None]) | (j >= pat.lengths[:, None])
    return acc & ((base[None, :] + pat.lengths[:, None]) <= slens[:, None])


def _trim(mat, lens, is_sp, mode: str):
    w = mat.shape[1]
    pos = _arange(w, mat.device)
    in_str = pos < lens[:, None]
    nonsp = in_str & ~is_sp
    any_ns = nonsp.any(1)
    first = torch.where(any_ns, _first_true(nonsp), 0)
    last = torch.where(any_ns, _last_true(nonsp), -1)
    if mode == "ltrim":
        start, end = first, lens.long() - 1
    elif mode == "rtrim":
        start, end = torch.zeros_like(first), last
    else:
        start, end = first, last
    start = torch.where(any_ns, start, 0)
    end = torch.where(any_ns, end, -1)
    out_len = (end - start + 1).clamp(min=0)
    return _keep(_gather(mat, start[:, None] + pos), out_len), out_len.int()


def _append(out, out_len, piece, piece_len, use, total_w):
    """Write ``piece`` after each row's ``out_len`` bytes where ``use``."""
    pos = _arange(total_w, out.device)
    chunk = _gather(_fit(piece, total_w), pos - out_len[:, None])
    eff = torch.where(use, piece_len, 0)
    write = (pos >= out_len[:, None]) & (pos < (out_len + eff)[:, None])
    return torch.where(write, chunk, out), out_len + eff


def string_func(e: E.StringFunc, args: List[ColumnVector]) -> ColumnVector:
    """One StringFunc over its evaluated (padded) arguments."""
    f, dt = e.func, e.dtype
    cv = args[0]
    mat, lens = cv.data, cv.lengths
    dev = mat.device
    cap = cv.capacity
    w = mat.shape[1] if cv.dtype.is_binary else 0
    if f in ("length", "char_length", "octet_length", "bit_length"):
        n = lens.int() * (8 if f == "bit_length" else 1)
        return ColumnVector(n, cv.validity, None, T.INT32)
    if f in ("upper", "lower"):
        if f == "upper":
            data = torch.where((mat >= ord("a")) & (mat <= ord("z")), mat - 32, mat)
        else:
            data = torch.where((mat >= ord("A")) & (mat <= ord("Z")), mat + 32, mat)
        return ColumnVector(data, cv.validity, lens, dt)
    if f == "ascii":
        return ColumnVector(torch.where(lens > 0, mat[:, 0].int(), 0), cv.validity, None,
                            T.INT32)
    if f == "reverse":
        pos = _arange(w, dev)
        data = _keep(_gather(mat, lens.long()[:, None] - 1 - pos), lens)
        return ColumnVector(data, cv.validity, lens, dt)
    if f == "substring":
        p = args[1].data.long()
        n = args[2].data.long().clamp(min=0) if len(args) > 2 else torch.full_like(p, w)
        ln = lens.long()
        start = torch.where(p > 0, p - 1, torch.where(p == 0, 0, (ln + p).clamp(min=0)))
        out_len = (torch.minimum(start + n, ln) - start).clamp(min=0)
        data = _keep(_gather(mat, start[:, None] + _arange(w, dev)), out_len)
        return ColumnVector(data, cv.validity, out_len.int(), dt)
    if f in ("left", "right"):
        out_len = torch.minimum(args[1].data.long().clamp(min=0), lens.long())
        pos = _arange(w, dev)
        src = pos if f == "left" else (lens.long() - out_len)[:, None] + pos
        data = _keep(_gather(mat, src), out_len)
        return ColumnVector(data, cv.validity & args[1].validity, out_len.int(), dt)
    if f == "chr":  # the byte of n % 256; empty where that is 0 or n < 0
        n = cv.data.long()
        code = n % 256
        ok = (n >= 0) & (code > 0)
        return ColumnVector(torch.where(ok, code, 0).to(torch.uint8)[:, None], cv.validity,
                            ok.int(), dt)
    if f == "space":
        out_w = dt.byte_width
        n = cv.data.long().clamp(0, out_w)
        data = torch.where(_arange(out_w, dev) < n[:, None], ord(" "), 0).to(torch.uint8)
        return ColumnVector(data, cv.validity, n.int(), dt)
    if f == "btrim":
        in_str = _arange(w, dev) < lens[:, None]
        if len(args) > 1:  # a set of trim bytes
            tr = args[1]
            member = torch.zeros((cap, w), dtype=torch.bool, device=dev)
            for j in range(tr.data.shape[1]):
                member |= (mat == tr.data[:, j][:, None]) & (j < tr.lengths[:, None])
            is_sp, validity = member & in_str, cv.validity & tr.validity
        else:
            is_sp, validity = (mat == 32) & in_str, cv.validity
        data, out_len = _trim(mat, lens, is_sp, "trim")
        return ColumnVector(data, validity, out_len, dt)
    if f in ("trim", "ltrim", "rtrim"):
        is_sp = (mat == 32) & (_arange(w, dev) < lens[:, None])
        data, out_len = _trim(mat, lens, is_sp, f)
        return ColumnVector(data, cv.validity, out_len, dt)
    if f == "concat_ws":  # null parts are skipped; null only with a null separator
        sep, total_w = args[0], dt.byte_width
        out = torch.zeros((cap, total_w), dtype=torch.uint8, device=dev)
        out_len = torch.zeros(cap, dtype=torch.int64, device=dev)
        n_written = torch.zeros(cap, dtype=torch.int64, device=dev)
        for a in args[1:]:
            use = a.validity
            out, out_len = _append(out, out_len, sep.data, sep.lengths.long(),
                                   use & (n_written > 0), total_w)
            out, out_len = _append(out, out_len, a.data, a.lengths.long(), use, total_w)
            n_written = n_written + use.long()
        return ColumnVector(out, sep.validity, out_len.clamp(max=total_w).int(), dt)
    if f == "concat":
        total_w = dt.byte_width
        out = torch.zeros((cap, total_w), dtype=torch.uint8, device=dev)
        out_len = torch.zeros(cap, dtype=torch.int64, device=dev)
        validity = torch.ones(cap, dtype=torch.bool, device=dev)
        for a in args:
            out, out_len = _append(out, out_len, a.data, a.lengths.long(),
                                   torch.ones_like(validity), total_w)
            validity = validity & a.validity
        return ColumnVector(out, validity, out_len.clamp(max=total_w).int(), dt)
    if f in ("startswith", "endswith", "contains"):
        pat = args[1]
        pw = pat.data.shape[1]
        validity = cv.validity & pat.validity
        in_pat = _arange(pw, dev) < pat.lengths[:, None]
        if f == "startswith":
            comp = torch.where(in_pat, _fit(mat, pw) == pat.data, True)
            data = comp.all(1) & (pat.lengths <= lens)
        elif f == "endswith":
            start = (lens - pat.lengths).clamp(min=0).long()
            tail = _gather(pad_width(mat, max(w, pw)), start[:, None] + _arange(pw, dev))
            data = torch.where(in_pat, tail == pat.data, True).all(1) & (pat.lengths <= lens)
        else:
            data = _match_starts(mat, lens, pat).any(1) | (pat.lengths == 0)
        return ColumnVector(data, validity, None, T.BOOL)
    if f in ("lpad", "rpad"):  # cut where the target is shorter than the string
        out_w = dt.byte_width
        pos = _arange(out_w, dev)
        tgt = args[1].data.long().clamp(0, out_w)
        pad = args[2] if len(args) > 2 else None
        ln = lens.long()
        if f == "rpad":
            from_str = _fit(mat, out_w)
            in_str = pos < torch.minimum(ln, tgt)[:, None]
            pidx = (pos - ln[:, None]) % (pad.lengths.long().clamp(min=1)[:, None]
                                          if pad is not None else 1)
        else:
            shift = (tgt - ln).clamp(min=0)
            from_str = _gather(mat, pos - shift[:, None]) if w else \
                torch.zeros((cap, out_w), dtype=torch.uint8, device=dev)
            in_str = (pos >= shift[:, None]) & (pos < tgt[:, None])
            pidx = pos % (pad.lengths.long().clamp(min=1)[:, None] if pad is not None else 1)
        if pad is not None:
            padch = _gather(pad.data, pidx.expand(cap, -1))
        else:
            padch = torch.full((cap, out_w), 32, dtype=torch.uint8, device=dev)
        data = _keep(torch.where(in_str, from_str, padch), tgt)
        return ColumnVector(data, cv.validity & args[1].validity, tgt.int(), dt)
    if f == "repeat":
        out_w = dt.byte_width
        pos = _arange(out_w, dev)
        out_len = (lens.long() * args[1].data.long().clamp(min=0)).clamp(0, out_w)
        sidx = pos % lens.long().clamp(min=1)[:, None]
        data = _keep(_gather(mat, sidx), out_len)
        return ColumnVector(data, cv.validity & args[1].validity, out_len.int(), dt)
    if f == "replace":
        return _replace_equal_len(cv, args[1], args[2], dt)
    if f == "translate":  # (str, from literal, to literal), byte for byte
        fb, tb = (a.value.encode() if isinstance(a.value, str) else bytes(a.value)
                  for a in (e.args[1], e.args[2]))
        lut = np.arange(256, dtype=np.int16)
        for i, chb in enumerate(fb):
            lut[chb] = tb[i] if i < len(tb) else 0
        return ColumnVector(torch.from_numpy(lut.astype(np.uint8)).to(dev)[mat.long()],
                            cv.validity, lens, dt)
    if f == "initcap":  # the first byte and each byte after a space upper, the rest lower
        prev_sep = torch.cat([torch.ones((cap, 1), dtype=torch.bool, device=dev),
                              mat[:, :-1] == 32], dim=1)
        up = torch.where(prev_sep & (mat >= ord("a")) & (mat <= ord("z")), mat - 32, mat)
        low = torch.where(~prev_sep & (mat >= ord("A")) & (mat <= ord("Z")), up + 32, up)
        return ColumnVector(low, cv.validity, lens, dt)
    if f == "levenshtein":
        return _levenshtein(cv, args[1])
    if f in ("instr", "locate"):  # the 1-based position of the first match, 0 if none
        pat, s = (args[1], cv) if f == "instr" else (args[0], args[1])
        m = _match_starts(s.data, s.lengths, pat)
        data = torch.where(m.any(1), _first_true(m) + 1, 0).int()
        return ColumnVector(data, s.validity & pat.validity, None, T.INT32)
    raise NotImplementedError(f"string func {f}")


def _replace_equal_len(cv: ColumnVector, search: ColumnVector, repl: ColumnVector,
                       out_t: T.DataType) -> ColumnVector:
    """replace() where the search and the replacement have one length:
    each match, left to right without overlap, overwritten in place."""
    mat, lens = cv.data, cv.lengths
    cap, w = mat.shape
    starts = _match_starts(mat, lens, search) & (search.lengths[:, None] > 0)
    slen = search.lengths.long()
    run = torch.zeros(cap, dtype=torch.int64, device=mat.device)
    cols = []
    for p in range(w):
        run = torch.where(starts[:, p] & (run <= 0), slen, run)
        cols.append(torch.where(run > 0, slen - run, -1))
        run = run - 1
    offin = torch.stack(cols, dim=1)  # the offset within a match, else -1
    rch = _gather(pad_width(repl.data, max(repl.data.shape[1], 1)), offin)
    data = torch.where(offin >= 0, rch, mat)
    return ColumnVector(data, cv.validity & search.validity & repl.validity, lens, out_t)


def _levenshtein(a: ColumnVector, b: ColumnVector) -> ColumnVector:
    """Edit distance by the row-by-row DP, vectorized over the rows: one
    step per byte of ``a``, each a prefix minimum across ``b``'s bytes."""
    am, al = a.data.int(), a.lengths
    bm, bl = b.data.int(), b.lengths
    cap, wa = am.shape
    wb = bm.shape[1]
    dev = am.device
    dp = torch.arange(wb + 1, dtype=torch.int32, device=dev)[None, :].expand(cap, -1)
    beyond = torch.arange(wb, device=dev)[None, :] >= bl[:, None]
    for i in range(wa):
        sub_cost = ((am[:, i][:, None] != bm) | beyond).int()
        cand = torch.minimum(dp[:, 1:] + 1, dp[:, :-1] + sub_cost)
        col = dp[:, 0] + 1
        new = [col]
        for j in range(wb):
            col = torch.minimum(cand[:, j], col + 1)
            new.append(col)
        dp = torch.where((i < al)[:, None], torch.stack(new, dim=1), dp)
    out = dp.gather(1, bl.clamp(max=wb).long()[:, None])[:, 0]
    return ColumnVector(out.int(), a.validity & b.validity, None, T.INT32)


# ---- split_part, substring_index, soundex (JAX ``exec/split_device.py``) -------------

_SOUNDEX_LUT = np.zeros(256, np.int64)
for _c, _v in (("BFPV", 1), ("CGJKQSXZ", 2), ("DT", 3), ("L", 4), ("MN", 5), ("R", 6)):
    for _ch in _c:
        _SOUNDEX_LUT[ord(_ch)] = _v


def soundex(cv: ColumnVector, out_t: T.DataType) -> ColumnVector:
    """American Soundex: the first letter and up to three digit codes,
    repeats collapsed, H and W transparent, other non-letters resetting the
    previous code; a row whose first byte is not an ASCII letter passes
    through unchanged."""
    mat, lens = cv.data, cv.lengths
    n, W = mat.shape
    out_w = out_t.byte_width
    dev = mat.device
    up = torch.where((mat >= 97) & (mat <= 122), mat - 32, mat).long()
    codes = torch.from_numpy(_SOUNDEX_LUT).to(dev)[up]
    hw = (up == 72) | (up == 87)
    live = torch.arange(W, device=dev)[None, :] < lens[:, None]
    alpha0 = (up[:, 0] >= 65) & (up[:, 0] <= 90) & (lens > 0)
    prev = codes[:, 0]
    k = torch.zeros(n, dtype=torch.int64, device=dev)
    c = [torch.zeros(n, dtype=torch.int64, device=dev) for _ in range(3)]
    for j in range(1, W):
        code, lv = codes[:, j], live[:, j]
        emit = lv & (code > 0) & (code != prev) & (k < 3)
        for slot in range(3):
            c[slot] = torch.where(emit & (k == slot), code, c[slot])
        k = k + emit.long()
        prev = torch.where(lv & ~hw[:, j], code, prev)
    out = torch.zeros((n, max(out_w, 4)), dtype=torch.int64, device=dev)
    out[:, 0] = up[:, 0]
    for slot in range(3):
        out[:, 1 + slot] = ord("0") + c[slot]
    outb = torch.where(alpha0[:, None], out[:, :out_w].to(torch.uint8), _fit(mat, out_w))
    return ColumnVector(outb, cv.validity, torch.where(alpha0, 4, lens).int(), out_t)


def _nonoverlap_matches(mat: torch.Tensor, lens: torch.Tensor, delim: bytes) -> torch.Tensor:
    """(rows, W) bool: the starts of the delimiter's left-to-right
    non-overlapping matches."""
    n, W = mat.shape
    L = len(delim)
    pad = pad_width(mat, W + L)
    occ = torch.ones((n, W), dtype=torch.bool, device=mat.device)
    for k, byte in enumerate(delim):
        occ &= pad[:, k: k + W] == byte
    occ &= (torch.arange(W, device=mat.device)[None, :] + L) <= lens[:, None]
    if L == 1:
        return occ
    cool = torch.zeros(n, dtype=torch.int64, device=mat.device)
    cols = []
    for j in range(W):
        take = occ[:, j] & (cool == 0)
        cool = torch.where(take, L - 1, (cool - 1).clamp(min=0))
        cols.append(take)
    return torch.stack(cols, dim=1)


def _split_fields(mat, lens, delim: bytes, max_parts: int):
    """(starts (n, E), ends (n, E), fields (n,), overflow (n,)) of the
    fields between matches; fields past the last carry (len, len)."""
    L = len(delim)
    real = _nonoverlap_matches(mat, lens, delim)
    n, W = mat.shape
    dev = mat.device
    rank = real.long().cumsum(1) - 1
    ms = torch.arange(max_parts, device=dev)
    oh = real[:, None, :] & (rank[:, None, :] == ms[None, :, None])
    pos = (oh.long() * torch.arange(W, device=dev)[None, None, :]).sum(-1)
    has = oh.any(-1)
    n_fields = real.sum(1) + 1
    ln = lens.long()[:, None]
    ends = torch.where(has, pos, ln)
    starts = torch.cat([torch.zeros((n, 1), dtype=torch.int64, device=dev),
                        torch.where(has, pos + L, ln)[:, : max_parts - 1]], dim=1)
    return starts, ends, n_fields, n_fields > max_parts


def _span(mat: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor, out_w: int):
    flen = (ends - starts).clamp(0, out_w)
    data = _keep(_gather(mat, starts[:, None] + _arange(out_w, mat.device)), flen)
    return data, flen.int()


def split(cv: ColumnVector, delim: bytes, max_parts: int, out_w: int):
    """split with limit -1 over the same field scan as ``split_part`` (JAX
    ``split_device.py:160``) -> (field counts (n,), element bytes (n, E,
    out_w), element lengths (n, E), element validity (n, E), overflow (n,))."""
    mat, lens, validity = cv.data, cv.lengths, cv.validity
    n, w = mat.shape
    dev = mat.device
    starts, ends, n_fields, overflow = _split_fields(mat, lens, delim, max_parts)
    flen = (ends - starts).clamp(0, out_w)
    c = torch.arange(out_w, device=dev)
    idx = (starts[:, :, None] + c).clamp(0, max(w - 1, 0)).reshape(n, -1)
    got = (mat.gather(1, idx) if w else torch.zeros_like(idx, dtype=mat.dtype))
    got = got.reshape(n, max_parts, out_w)
    data = torch.where(c < flen[..., None], got, torch.zeros((), dtype=got.dtype, device=dev))
    present = torch.arange(max_parts, device=dev)[None, :] < n_fields[:, None]
    counts = torch.where(validity, n_fields.clamp(max=max_parts), 0)
    return (counts.int(), data, torch.where(present, flen, 0).int(),
            present & validity[:, None], overflow & validity)


def split_part(cv: ColumnVector, delim: bytes, part: int, max_parts: int, out_t: T.DataType):
    """-> (column, overflow flags, part-0 flags)."""
    mat, lens, validity = cv.data, cv.lengths, cv.validity
    n = mat.shape[0]
    out_w = out_t.byte_width
    none = torch.zeros(n, dtype=torch.bool, device=mat.device)
    if part == 0:
        return (ColumnVector(torch.zeros((n, out_w), dtype=torch.uint8, device=mat.device),
                             validity, torch.zeros(n, dtype=torch.int32, device=mat.device),
                             out_t), none, validity.clone())
    starts, ends, n_fields, overflow = _split_fields(mat, lens, delim, max_parts)
    k = torch.full_like(n_fields, part) if part > 0 else n_fields + (part + 1)
    ok = (k >= 1) & (k <= n_fields)
    f = (k - 1).clamp(0, max_parts - 1)[:, None]
    s, e = starts.gather(1, f)[:, 0], ends.gather(1, f)[:, 0]
    data, fl = _span(mat, torch.where(ok, s, 0), torch.where(ok, e, 0), out_w)
    return (ColumnVector(data, validity, torch.where(ok, fl, 0), out_t), overflow & validity,
            none)


def substring_index(cv: ColumnVector, delim: bytes, count: int, max_parts: int,
                    out_t: T.DataType):
    """-> (column, overflow flags)."""
    mat, lens, validity = cv.data, cv.lengths, cv.validity
    n = mat.shape[0]
    out_w = out_t.byte_width
    dev = mat.device
    if count == 0:
        return (ColumnVector(torch.zeros((n, out_w), dtype=torch.uint8, device=dev), validity,
                             torch.zeros(n, dtype=torch.int32, device=dev), out_t),
                torch.zeros(n, dtype=torch.bool, device=dev))
    if count > 0:
        starts, ends, n_fields, overflow = _split_fields(mat, lens, delim, max_parts)
        f = min(count - 1, max_parts - 1)
        end = torch.where(n_fields > count, ends[:, f], lens.long())
        data, fl = _span(mat, torch.zeros(n, dtype=torch.int64, device=dev), end, out_w)
        return ColumnVector(data, validity, fl, out_t), overflow & validity
    assert len(delim) == 1, "a right-scan substring_index takes a one-byte delimiter"
    occ = _nonoverlap_matches(mat, lens, delim)
    want = occ.sum(1) + count  # the left rank of the cut match
    rank = occ.long().cumsum(1) - 1
    oh = occ & (rank == want.clamp(min=0)[:, None])
    pos = (oh.long() * torch.arange(mat.shape[1], device=dev)[None, :]).sum(1)
    data, fl = _span(mat, torch.where(want >= 0, pos + 1, 0), lens.long(), out_w)
    return ColumnVector(data, validity, fl, out_t), torch.zeros(n, dtype=torch.bool, device=dev)


# ---- format_number (JAX ``exec/format_number.py``) --------------------------------------


def _scale_to_int(data: torch.Tensor, in_scale: int, decimals: int):
    """Unscaled int64 at ``in_scale`` -> (|value| at ``decimals``,
    negative, overflow), HALF_EVEN when it drops digits."""
    v = data.long()
    neg = v < 0
    mag = torch.where(neg, -v, v)
    if decimals >= in_scale:
        f = 10 ** (decimals - in_scale)
        return mag * f, neg, mag > (2**63 - 1) // f
    q = 10 ** (in_scale - decimals)
    t, r = mag // q, mag % q
    half = q // 2
    rup = (r > half) | ((r == half) & (t % 2 == 1))
    return t + rup.long(), neg, torch.zeros_like(neg)


def _format_grouped(mag, neg, d: int, width: int, is_nan=None, is_inf=None):
    """(|value| x 10^d as int64, negative) -> (bytes (n, width), lengths,
    too wide): d fraction digits, the integer part comma-grouped."""
    n = mag.shape[0]
    dev = mag.device
    base = d + (1 if d else 0)
    NI = 19
    ip = mag // 10**d if d else mag
    ni = torch.ones(n, dtype=torch.int64, device=dev)
    for k in range(1, NI):
        ni = torch.where(ip >= 10**k, k + 1, ni)
    length = base + ni + (ni - 1) // 3 + neg.long()
    wmax = base + NI + (NI - 1) // 3 + 1
    cols = []
    for r in range(wmax):
        if d and r < d:
            ch = (mag // 10**r) % 10 + ord("0")
        elif d and r == d:
            ch = torch.full((n,), ord("."), dtype=torch.int64, device=dev)
        else:
            rp = r - base
            if rp % 4 == 3:
                ch = torch.where(ni > 3 * (rp // 4 + 1), ord(","), 0)
            else:
                j = rp - rp // 4
                p = d + j
                if p >= 19:
                    ch = torch.zeros(n, dtype=torch.int64, device=dev)
                else:
                    ch = torch.where(j < ni, (mag // 10**p) % 10 + ord("0"), 0)
        ch = torch.where(neg & (r == length - 1), ord("-"), ch)
        cols.append(torch.where(r < length, ch, 0))
    rev = torch.stack(cols, dim=1)  # right-aligned, reversed
    k = torch.arange(width, device=dev)[None, :]
    out = rev.gather(1, (length[:, None] - 1 - k).clamp(0, wmax - 1))
    out = torch.where(k < length[:, None], out, 0)
    lens = length
    if is_nan is not None:
        for i, c in enumerate(b"nan"[:width]):
            out[:, i] = torch.where(is_nan, c, out[:, i])
        inf = torch.tensor(list(b"-inf"), device=dev)
        pinf = torch.tensor(list(b"inf") + [0], device=dev)
        for i in range(min(4, width)):
            out[:, i] = torch.where(is_inf, torch.where(neg, inf[i], pinf[i]), out[:, i])
        lens = torch.where(is_nan, 3, lens)
        lens = torch.where(is_inf, torch.where(neg, 4, 3), lens)
    return out.to(torch.uint8), lens.clamp(max=width).int(), lens > width


def format_number(cv: ColumnVector, decimals: int, out_t: T.DataType
                  ) -> Tuple[ColumnVector, torch.Tensor]:
    """-> (column, flags of rows that do not fit). A two-limb decimal
    raises, as in the JAX package."""
    dt = cv.dtype
    is_nan = is_inf = None
    if dt.is_decimal:
        if cv.data.dim() != 1:
            raise NotImplementedError("format_number of a two-limb decimal")
        mag, neg, ovf = _scale_to_int(cv.data, dt.scale, decimals)
    elif dt.is_floating:
        x = cv.data.double() * (10.0**decimals)
        is_nan, is_inf = torch.isnan(x), torch.isinf(x)
        rx = torch.round(x)  # half to even
        neg = torch.signbit(rx) | torch.signbit(x)
        fin = ~(is_nan | is_inf)
        ovf = fin & (rx.abs() >= 2.0**62)
        mag = torch.where(fin & ~ovf, rx.abs(), 0.0).long()
    else:
        mag, neg, ovf = _scale_to_int(cv.data, 0, decimals)
    chars, lens, wide = _format_grouped(mag, neg, decimals, out_t.byte_width, is_nan, is_inf)
    return ColumnVector(chars, cv.validity, lens, out_t), (ovf | wide) & cv.validity
