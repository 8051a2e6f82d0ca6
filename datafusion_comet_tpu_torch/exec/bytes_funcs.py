"""Byte-level functions over padded (rows, w) uint8 matrices (port of
``datafusion_comet_tpu/exec/bytes_funcs.py``): hex and unhex, base64 and
unbase64, bin, conv, crc32, md5, sha1 and sha2 at 224, 256, 384 and 512
bits, with Spark's semantics as the JAX package has them.

PyTorch has no unsigned 32- or 64-bit arithmetic on the GPU, so the
digests keep their words in int64 lanes: the 32-bit ones (crc32, md5,
sha1, sha-224/256) masked to their low 32 bits after each add or shift,
the 64-bit ones (sha-384/512) as two's-complement bit patterns, whose adds
and multiplies wrap as unsigned ones do; a logical right shift masks off
the sign bits that int64's arithmetic shift brings in (``_lsr64``). conv's
unsigned 64-bit accumulator compares and divides the same way
(``_ugt``, ``_udivmod``). A row's blocks and rounds are Python loops of
elementwise ops over all rows at once (each op one launch); crc32 takes
one gather of a 256-entry table per byte column.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from datafusion_comet_tpu_torch import types as T

__all__ = ["hex_of_int", "hex_of_bytes", "unhex", "base64_encode", "base64_decode",
           "bin_of_int", "conv", "crc32", "md5", "sha1", "sha2"]

_M32 = 0xFFFFFFFF
_MIN64 = -(1 << 63)


def _s64(c: int) -> int:
    """An unsigned 64-bit constant as its int64 bit pattern."""
    return c - (1 << 64) if c >= (1 << 63) else c


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8)


def _pos(n: int, dev) -> torch.Tensor:
    return torch.arange(n, device=dev)[None, :]


def _fit_width(mat: torch.Tensor, out_w: int) -> torch.Tensor:
    w = mat.shape[1]
    if out_w <= w:
        return mat[:, :out_w]
    return torch.nn.functional.pad(mat, (0, out_w - w))


def _keep(mat: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Zero each row past its first ``n`` bytes."""
    return torch.where(_pos(mat.shape[1], mat.device) < n[:, None], mat, 0)


def _nibble_char(nib: torch.Tensor, lower: bool = False) -> torch.Tensor:
    """4-bit values -> hex ASCII, upper case unless ``lower``."""
    return _u8(torch.where(nib < 10, nib + ord("0"), nib - 10 + ord("a" if lower else "A")))


def hex_of_bytes(mat: torch.Tensor, lens: torch.Tensor, out_t: T.DataType):
    """hex(binary): each byte two upper-case hex digits."""
    cap, w = mat.shape
    m = mat.int()
    out = torch.stack([_nibble_char(m >> 4), _nibble_char(m & 0xF)], 2).reshape(cap, 2 * w)
    out = _fit_width(out, out_t.byte_width)
    out_len = (lens * 2).int()
    return _keep(out, out_len), out_len


def _strip_leading(mat: torch.Tensor, zero: int):
    """Rows of digits (most significant first) without their leading
    ``zero`` characters (one kept for an all-zero row): (bytes, lengths)."""
    n = mat.shape[1]
    nz = mat != zero
    first = torch.where(nz.any(1), nz.to(torch.uint8).argmax(1), n - 1)
    out_len = (n - first).int()
    pos = _pos(n, mat.device)
    out = mat.gather(1, (first[:, None] + pos).clamp(0, n - 1))
    return _keep(out, out_len), out_len


def hex_of_int(v: torch.Tensor, out_t: T.DataType):
    """hex(bigint): upper case, no leading zeros; a negative value as its
    16-digit two's complement (Spark's Hex of a LongType)."""
    u = v.long()
    mat = torch.stack([_nibble_char((u >> (4 * k)) & 0xF) for k in range(15, -1, -1)], 1)
    out, out_len = _strip_leading(mat, ord("0"))
    return _fit_width(out, out_t.byte_width), out_len


def _hex_val(c: torch.Tensor) -> torch.Tensor:
    """ASCII -> hex digit value, 255 where not a hex digit."""
    c = c.int()
    v = torch.where((c >= ord("0")) & (c <= ord("9")), c - ord("0"), 255)
    v = torch.where((c >= ord("A")) & (c <= ord("F")), c - ord("A") + 10, v)
    return torch.where((c >= ord("a")) & (c <= ord("f")), c - ord("a") + 10, v)


def unhex(mat: torch.Tensor, lens: torch.Tensor, out_t: T.DataType):
    """unhex(str) -> (bytes, lengths, invalid): an odd length takes an
    implicit leading 0 nibble; a non-hex digit makes the row invalid (the
    caller nulls it)."""
    cap, w = mat.shape
    dev = mat.device
    vals = _hex_val(mat)
    in_str = _pos(w, dev) < lens[:, None]
    invalid = ((vals == 255) & in_str).any(1)
    odd = (lens & 1).long()
    out_w = out_t.byte_width
    opos = _pos(out_w, dev)
    i_hi = 2 * opos - odd[:, None]
    i_lo = i_hi + 1
    vw = torch.where(in_str, vals, 0)
    hi = torch.where(i_hi >= 0, vw.gather(1, i_hi.clamp(0, w - 1)), 0)
    lo = vw.gather(1, i_lo.clamp(0, w - 1))
    out_len = ((lens + 1) // 2).int()
    return _keep(_u8((hi << 4) | lo), out_len), out_len, invalid


# base64: the RFC 4648 alphabet; chunked output wraps every 76 characters
# with CRLF (java.util.Base64's MIME encoder, Spark's default)
_B64_LINE = 76


def _b64_char(v: torch.Tensor) -> torch.Tensor:
    c = torch.where(v < 26, v + ord("A"), 0)
    c = torch.where((v >= 26) & (v < 52), v - 26 + ord("a"), c)
    c = torch.where((v >= 52) & (v < 62), v - 52 + ord("0"), c)
    c = torch.where(v == 62, ord("+"), c)
    return _u8(torch.where(v == 63, ord("/"), c))


def _b64_val(c: torch.Tensor) -> torch.Tensor:
    c = c.int()
    v = torch.where((c >= ord("A")) & (c <= ord("Z")), c - ord("A"), -1)
    v = torch.where((c >= ord("a")) & (c <= ord("z")), c - ord("a") + 26, v)
    v = torch.where((c >= ord("0")) & (c <= ord("9")), c - ord("0") + 52, v)
    v = torch.where(c == ord("+"), 62, v)
    return torch.where(c == ord("/"), 63, v)


def base64_encode(mat: torch.Tensor, lens: torch.Tensor, out_t: T.DataType, chunk: bool):
    cap, w = mat.shape
    dev = mat.device
    n3 = (w + 2) // 3
    m = _keep(_fit_width(mat, n3 * 3), lens).int()
    trip = m.reshape(cap, n3, 3)
    word = (trip[:, :, 0] << 16) | (trip[:, :, 1] << 8) | trip[:, :, 2]
    quad = torch.stack([_b64_char(word >> 18), _b64_char((word >> 12) & 63),
                        _b64_char((word >> 6) & 63), _b64_char(word & 63)], 2)
    quad = quad.reshape(cap, n3 * 4)
    enc_len = ((lens + 2) // 3 * 4).int()
    qpos = _pos(n3 * 4, dev)
    rem = lens % 3
    n_eq = torch.where(rem == 0, 0, 3 - rem)
    is_pad = (qpos >= (enc_len - n_eq)[:, None]) & (qpos < enc_len[:, None])
    quad = _keep(torch.where(is_pad, ord("="), quad), enc_len)
    out_w = out_t.byte_width
    if not chunk:
        return _fit_width(quad, out_w), enc_len
    # output byte j of a line of 78 (76 characters and CRLF) reads character
    # line * 76 + its place in the line
    opos = torch.arange(out_w, device=dev)
    line, in_line = opos // (_B64_LINE + 2), opos % (_B64_LINE + 2)
    src = (line * _B64_LINE + in_line.clamp(max=_B64_LINE - 1)).clamp(0, n3 * 4 - 1)
    g = _fit_width(quad, max(n3 * 4, 1)).gather(1, src[None, :].expand(cap, -1))
    out = torch.where((in_line == _B64_LINE)[None, :], ord("\r"),
                      torch.where((in_line == _B64_LINE + 1)[None, :], ord("\n"), g))
    n_lines_m1 = ((enc_len - 1) // _B64_LINE).clamp(min=0)
    out_len = torch.where(enc_len > 0, enc_len + 2 * n_lines_m1, 0).int()
    return _keep(_u8(out), out_len), out_len


def base64_decode(mat: torch.Tensor, lens: torch.Tensor, out_t: T.DataType):
    """unbase64: bytes outside the alphabet ('=', CR, LF too) are skipped,
    then each 4 sextets give 3 bytes; a trailing group of k sextets gives
    k - 1 bytes (commons-codec, which Spark relies on)."""
    cap, w = mat.shape
    dev = mat.device
    pos = _pos(w, dev)
    vals = torch.where(pos < lens[:, None], _b64_val(mat), -1)
    keep = vals >= 0
    # the kept sextets moved left, in order
    perm = torch.argsort(torch.where(keep, pos, w + pos), dim=1)
    sext = torch.where(keep, vals, 0).gather(1, perm)
    n_kept = keep.sum(1)
    n4 = (w + 3) // 4
    sx = _fit_width(sext, n4 * 4).reshape(cap, n4, 4)
    word = (sx[:, :, 0] << 18) | (sx[:, :, 1] << 12) | (sx[:, :, 2] << 6) | sx[:, :, 3]
    dec = torch.stack([_u8(word >> 16), _u8((word >> 8) & 0xFF), _u8(word & 0xFF)], 2)
    dec = _fit_width(dec.reshape(cap, n4 * 3), out_t.byte_width)
    out_len = (n_kept // 4 * 3 + ((n_kept % 4) - 1).clamp(min=0)).int()
    return _keep(dec, out_len), out_len


def bin_of_int(v: torch.Tensor, out_t: T.DataType):
    """bin(bigint): binary digits, a negative value as its 64-bit two's
    complement."""
    u = v.long()
    mat = torch.stack([_u8(torch.where(((u >> k) & 1) != 0, ord("1"), ord("0")))
                       for k in range(63, -1, -1)], 1)
    out, out_len = _strip_leading(mat, ord("0"))
    return _fit_width(out, out_t.byte_width), out_len


def _digit_val(c: torch.Tensor) -> torch.Tensor:
    """ASCII -> base-36 digit value, 99 where not a digit."""
    c = c.int()
    v = torch.where((c >= ord("0")) & (c <= ord("9")), c - ord("0"), 99)
    v = torch.where((c >= ord("A")) & (c <= ord("Z")), c - ord("A") + 10, v)
    return torch.where((c >= ord("a")) & (c <= ord("z")), c - ord("a") + 10, v)


def _ugt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a > b of int64 bit patterns."""
    return (a ^ _MIN64) > (b ^ _MIN64)


def _lsr64(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns, 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _udivmod(x: torch.Tensor, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned (x // d, x % d) of int64 bit patterns, 2 <= d < 2^62: half
    of x divides as a signed value; the remainder of the doubled quotient
    is below 2d."""
    q = (_lsr64(x, 1) // d) << 1
    r = x - q * d
    over = r >= d
    return q + over.long(), r - d * over.long()


def conv(mat: torch.Tensor, lens: torch.Tensor, from_base: int, to_base: int,
         out_t: T.DataType):
    """conv(numStr, fromBase, toBase) as Spark (Hive): an optional '-', the
    digits valid in fromBase up to the first invalid byte, accumulated as
    an unsigned 64-bit value saturating at its maximum; a negative toBase
    renders signed. -> (bytes, lengths, null): null where no digit."""
    cap, w = mat.shape
    dev = mat.device
    pos = _pos(w, dev)
    in_str = pos < lens[:, None]
    neg = (in_str[:, 0] & (mat[:, 0] == ord("-"))) if w > 0 else torch.zeros(
        cap, dtype=torch.bool, device=dev)
    start = neg.long()
    dv = _digit_val(mat)
    valid_digit = (dv < from_base) & in_str & (pos >= start[:, None])
    bad = ~valid_digit & (pos >= start[:, None])
    first_bad = torch.where(bad.any(1), bad.to(torch.uint8).argmax(1), w)
    use = valid_digit & (pos < first_bad[:, None])
    n_digits = first_bad - start
    # Horner in unsigned 64 bits: saturate where acc > (MAX - d) // base
    limits = torch.tensor([_s64(((1 << 64) - 1 - d) // from_base) for d in range(36)],
                          dtype=torch.int64, device=dev)
    acc = torch.zeros(cap, dtype=torch.int64, device=dev)
    for j in range(w):
        d = torch.where(use[:, j], dv[:, j], 0).long()
        nxt = torch.where(_ugt(acc, limits[d]), -1, acc * from_base + d)
        acc = torch.where(use[:, j], nxt, acc)
    null_out = n_digits <= 0
    acc = torch.where(neg, -acc, acc)  # two's complement negation
    tb = abs(to_base)
    if to_base < 0:
        out_neg = acc < 0
        mag = torch.where(out_neg, -acc, acc)
    else:
        out_neg = torch.zeros(cap, dtype=torch.bool, device=dev)
        mag = acc
    n_out = 64  # base >= 2: 64 digits hold any value
    digs: List[torch.Tensor] = []
    cur = mag
    for _ in range(n_out):
        cur, r = _udivmod(cur, tb)
        digs.append(r)
    d_arr = torch.stack(digs[::-1], 1)  # most significant first
    ch = _u8(torch.where(d_arr < 10, d_arr + ord("0"), d_arr - 10 + ord("A")))
    nz = d_arr != 0
    first_nz = torch.where(nz.any(1), nz.to(torch.uint8).argmax(1), n_out - 1)
    out_len = (n_out - first_nz + out_neg.long()).int()
    out_w = out_t.byte_width
    opos = _pos(out_w, dev)
    src = (first_nz[:, None] + opos - out_neg.long()[:, None]).clamp(0, n_out - 1)
    body = _fit_width(ch, max(n_out, out_w)).gather(1, src)[:, :out_w]
    out = torch.where(out_neg[:, None] & (opos == 0), ord("-"), body)
    return _keep(_u8(out), out_len), out_len, null_out


def _crc_table() -> List[int]:
    tab = []
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (0xEDB88320 if c & 1 else 0)
        tab.append(c)
    return tab


_CRC_TABLE = _crc_table()


def crc32(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """CRC-32 (IEEE 802.3, zlib's and Spark's polynomial) of each row's
    live bytes, int64: the byte-at-a-time table form of the JAX package's
    bitwise loop (the same function)."""
    cap, w = mat.shape
    tab = torch.tensor(_CRC_TABLE, dtype=torch.int64, device=mat.device)
    crc = torch.full((cap,), _M32, dtype=torch.int64, device=mat.device)
    for j in range(w):
        nxt = tab[(crc ^ mat[:, j].long()) & 0xFF] ^ (crc >> 8)
        crc = torch.where(j < lens, nxt, crc)
    return crc ^ _M32


def _padded_blocks(mat: torch.Tensor, lens: torch.Tensor, block: int, word: int,
                   little_endian: bool):
    """Merkle-Damgard padding of each row to ``block``-byte blocks (the
    0x80 byte, zeros, the bit length in the block's last 8 bytes): (words
    (cap, nb, block // word) int64, blocks per row, nb)."""
    cap, w = mat.shape
    dev = mat.device
    nb = (w + 1 + 2 * word + block - 1) // block
    pos = _pos(nb * block, dev)
    L = lens.long()[:, None]
    data = torch.where(pos < L, _fit_width(mat, nb * block).long(), 0)
    data = torch.where(pos == L, 0x80, data)
    n_blocks = (lens.long() + 2 * word) // block + 1
    len_start = n_blocks[:, None] * block - 8
    byte_idx = (pos - len_start).clamp(0, 7)
    shift = byte_idx * 8 if little_endian else (7 - byte_idx) * 8
    len_byte = ((lens.long() * 8)[:, None] >> shift) & 0xFF
    data = torch.where((pos >= len_start) & (pos < len_start + 8), len_byte, data)
    b = data.reshape(cap, nb, block // word, word)
    words = torch.zeros(b.shape[:3], dtype=torch.int64, device=dev)
    for k in range(word):
        words = words | (b[..., k] << (8 * (k if little_endian else word - 1 - k)))
    return words, n_blocks, nb


def _rotl32(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & _M32


def _rotr32(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _rotr64(x: torch.Tensor, n: int) -> torch.Tensor:
    return _lsr64(x, n) | (x << (64 - n))


def _hex_lower(words: List[torch.Tensor], nbytes: int, big_endian: bool, out_t: T.DataType):
    """The digest words' bytes as lower-case hex."""
    order = range(nbytes - 1, -1, -1) if big_endian else range(nbytes)
    b = torch.stack([(wd >> (8 * k)) & 0xFF for wd in words for k in order], 1)
    cap, n = b.shape
    out = torch.stack([_nibble_char(b >> 4, True), _nibble_char(b & 0xF, True)], 2)
    out = _fit_width(out.reshape(cap, 2 * n), out_t.byte_width)
    return out, torch.full((cap,), 2 * n, dtype=torch.int32, device=b.device)


def _blockwise(state: List[torch.Tensor], out: List[torch.Tensor], live: torch.Tensor,
               mask: int) -> List[torch.Tensor]:
    """Each row's chaining value after one block: state + out where the row
    has this block."""
    return [torch.where(live, (h + x) & mask if mask else h + x, h)
            for h, x in zip(state, out)]


_MD5_S = [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 + [6, 10, 15, 21] * 4
_MD5_K = [int(abs(math.sin(i + 1)) * (1 << 32)) & _M32 for i in range(64)]


def md5(mat: torch.Tensor, lens: torch.Tensor, out_t: T.DataType):
    cap = mat.shape[0]
    words, n_blocks, nb = _padded_blocks(mat, lens, 64, 4, True)
    state = [torch.full((cap,), v, dtype=torch.int64, device=mat.device)
             for v in (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)]
    for bi in range(nb):
        blk = words[:, bi]
        a, b, c, d = state
        for i in range(64):
            r = i // 16
            if r == 0:
                f, g = (b & c) | (~b & d), i
            elif r == 1:
                f, g = (d & b) | (~d & c), (5 * i + 1) % 16
            elif r == 2:
                f, g = b ^ c ^ d, (3 * i + 5) % 16
            else:
                f, g = c ^ (b | (~d & _M32)), (7 * i) % 16
            tmp = (f + a + _MD5_K[i] + blk[:, g]) & _M32
            a, b, c, d = d, (b + _rotl32(tmp, _MD5_S[i])) & _M32, b, c
        state = _blockwise(state, [a, b, c, d], bi < n_blocks, _M32)
    return _hex_lower(state, 4, False, out_t)


def sha1(mat: torch.Tensor, lens: torch.Tensor, out_t: T.DataType):
    cap = mat.shape[0]
    words, n_blocks, nb = _padded_blocks(mat, lens, 64, 4, False)
    state = [torch.full((cap,), v, dtype=torch.int64, device=mat.device)
             for v in (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)]
    ks = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)
    for bi in range(nb):
        sched = [words[:, bi, i] for i in range(16)]
        for i in range(16, 80):
            sched.append(_rotl32(sched[i - 3] ^ sched[i - 8] ^ sched[i - 14] ^ sched[i - 16], 1))
        a, b, c, d, e = state
        for i in range(80):
            r = i // 20
            if r == 0:
                f = (b & c) | (~b & d & _M32)
            elif r == 2:
                f = (b & c) | (b & d) | (c & d)
            else:
                f = b ^ c ^ d
            tmp = (_rotl32(a, 5) + f + e + ks[r] + sched[i]) & _M32
            a, b, c, d, e = tmp, a, _rotl32(b, 30), c, d
        state = _blockwise(state, [a, b, c, d, e], bi < n_blocks, _M32)
    return _hex_lower(state, 4, True, out_t)


_SHA256_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
_SHA224_H = [0xC1059ED8, 0x367CD507, 0x3070DD17, 0xF70E5939, 0xFFC00B31, 0x68581511, 0x64F98FA7,
             0xBEFA4FA4]
_SHA256_H = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB,
             0x5BE0CD19]


def _sha256_core(mat: torch.Tensor, lens: torch.Tensor, h_init: List[int], out_words: int,
                 out_t: T.DataType):
    cap = mat.shape[0]
    words, n_blocks, nb = _padded_blocks(mat, lens, 64, 4, False)
    state = [torch.full((cap,), v, dtype=torch.int64, device=mat.device) for v in h_init]
    for bi in range(nb):
        w = [words[:, bi, i] for i in range(16)]
        for i in range(16, 64):
            s0 = _rotr32(w[i - 15], 7) ^ _rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3)
            s1 = _rotr32(w[i - 2], 17) ^ _rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10)
            w.append((s1 + w[i - 7] + s0 + w[i - 16]) & _M32)
        a, b, c, d, e, f, g, h = state
        for i in range(64):
            s1 = _rotr32(e, 6) ^ _rotr32(e, 11) ^ _rotr32(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = h + s1 + ch + _SHA256_K[i] + w[i]
            s0 = _rotr32(a, 2) ^ _rotr32(a, 13) ^ _rotr32(a, 22)
            t2 = s0 + ((a & b) ^ (a & c) ^ (b & c))
            a, b, c, d, e, f, g, h = (t1 + t2) & _M32, a, b, c, (d + t1) & _M32, e, f, g
        state = _blockwise(state, [a, b, c, d, e, f, g, h], bi < n_blocks, _M32)
    return _hex_lower(state[:out_words], 4, True, out_t)


_SHA512_K = [_s64(k) for k in (
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817)]
_SHA384_H = [_s64(h) for h in (
    0xCBBB9D5DC1059ED8, 0x629A292A367CD507, 0x9159015A3070DD17, 0x152FECD8F70E5939,
    0x67332667FFC00B31, 0x8EB44A8768581511, 0xDB0C2E0D64F98FA7, 0x47B5481DBEFA4FA4)]
_SHA512_H = [_s64(h) for h in (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179)]


def _sha512_core(mat: torch.Tensor, lens: torch.Tensor, bits: int, out_t: T.DataType):
    """sha-384/512: 128-byte blocks, 64-bit words as int64 bit patterns
    (the length field's high 8 bytes stay zero: rows are far below 2^61
    bytes)."""
    cap = mat.shape[0]
    words, n_blocks, nb = _padded_blocks(mat, lens, 128, 8, False)
    h_init = _SHA384_H if bits == 384 else _SHA512_H
    state = [torch.full((cap,), v, dtype=torch.int64, device=mat.device) for v in h_init]
    for bi in range(nb):
        w = [words[:, bi, i] for i in range(16)]
        for i in range(16, 80):
            s0 = _rotr64(w[i - 15], 1) ^ _rotr64(w[i - 15], 8) ^ _lsr64(w[i - 15], 7)
            s1 = _rotr64(w[i - 2], 19) ^ _rotr64(w[i - 2], 61) ^ _lsr64(w[i - 2], 6)
            w.append(s1 + w[i - 7] + s0 + w[i - 16])
        a, b, c, d, e, f, g, h = state
        for i in range(80):
            s1 = _rotr64(e, 14) ^ _rotr64(e, 18) ^ _rotr64(e, 41)
            ch = (e & f) ^ (~e & g)
            t1 = h + s1 + ch + _SHA512_K[i] + w[i]
            s0 = _rotr64(a, 28) ^ _rotr64(a, 34) ^ _rotr64(a, 39)
            t2 = s0 + ((a & b) ^ (a & c) ^ (b & c))
            a, b, c, d, e, f, g, h = t1 + t2, a, b, c, d + t1, e, f, g
        state = _blockwise(state, [a, b, c, d, e, f, g, h], bi < n_blocks, 0)
    return _hex_lower(state[:6 if bits == 384 else 8], 8, True, out_t)


def sha2(mat: torch.Tensor, lens: torch.Tensor, bits: int, out_t: T.DataType):
    """sha2(expr, bitLength): 0 or 256 sha-256, 224, 384 and 512."""
    if bits in (0, 256):
        return _sha256_core(mat, lens, _SHA256_H, 8, out_t)
    if bits == 224:
        return _sha256_core(mat, lens, _SHA224_H, 7, out_t)
    if bits in (384, 512):
        return _sha512_core(mat, lens, bits, out_t)
    raise NotImplementedError(f"sha2 bit length {bits}")
