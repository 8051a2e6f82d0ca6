"""Dictionary-encoded string columns: (sorted host dictionary, int32 codes)
(port of ``datafusion_comet_tpu/exec/dictionary.py``).

The dictionary is built once at staging and stays host numpy, so predicates
against string literals become int32 code compares (the literal's rank is a
host constant), group-by keys have a provably tiny domain (the dense bucket
path), and a sort key is one int32 limb. The dictionary is sorted by unsigned
byte order, shorter prefix first, so codes are order-isomorphic to string
order. Where bytes are needed (a comparison of two different dictionaries,
a dictionary against a padded column, murmur3, a join against a padded key)
``decode_arrays`` turns codes into the padded layout with one gather from a
device copy of the dictionary, made once per device and width.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["StringDict", "union_ranks", "encode_padded", "encode_objects"]


class StringDict:
    """An immutable sorted string dictionary: values (K, w) uint8 zero-padded
    plus lengths (K,) int32. Equal by content digest."""

    __slots__ = ("values", "lengths", "_digest", "_keys", "_on_device")

    def __init__(self, values: np.ndarray, lengths: np.ndarray):
        assert values.ndim == 2 and values.dtype == np.uint8
        self.values = values
        self.lengths = lengths.astype(np.int32)
        h = hashlib.blake2b(digest_size=16)
        h.update(values.tobytes())
        h.update(self.lengths.tobytes())
        h.update(str(values.shape).encode())
        self._digest = h.digest()
        self._keys: Optional[list] = None  # lazy: sorted list of bytes
        self._on_device: dict = {}  # (device, width) -> (values, lengths) tensors

    def __hash__(self) -> int:
        return hash(self._digest)

    def __eq__(self, other) -> bool:
        return isinstance(other, StringDict) and self._digest == other._digest

    def __repr__(self) -> str:
        return f"StringDict(size={self.size}, width={self.width})"

    @property
    def size(self) -> int:
        return self.values.shape[0]

    @property
    def width(self) -> int:
        return self.values.shape[1]

    def _key_list(self) -> list:
        if self._keys is None:
            self._keys = [bytes(self.values[i, : self.lengths[i]]) for i in range(self.size)]
        return self._keys

    def insertion_point(self, value: bytes, side: str = "left") -> int:
        """#entries strictly < value (side=left) or <= value (side=right)."""
        ks = self._key_list()
        return bisect.bisect_left(ks, value) if side == "left" else bisect.bisect_right(ks, value)

    def value_of(self, code: int) -> bytes:
        return self._key_list()[code]

    def device_arrays(self, device: torch.device, width: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values (max(K, 1), width) uint8, lengths (max(K, 1),) int32) on
        ``device``, cut or zero-padded to ``width``: copied once, then reused
        by every decode (the JAX package's copy is a trace-time constant)."""
        key = (str(device), width)
        hit = self._on_device.get(key)
        if hit is None:
            vals = np.zeros((max(self.size, 1), width), np.uint8)
            cw = min(width, self.width)
            vals[: self.size, :cw] = self.values[:, :cw]
            lens = np.zeros(max(self.size, 1), np.int32)
            lens[: self.size] = self.lengths
            hit = (torch.from_numpy(vals).to(device), torch.from_numpy(lens).to(device))
            self._on_device[key] = hit
        return hit

    def decode_arrays(self, codes: torch.Tensor, target_width: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """codes (cap,) int32 -> (mat (cap, w) uint8, lens (cap,) int32):
        one gather of each from the device copy (an empty dictionary gives
        zeros); codes out of range are clamped, as in the JAX package."""
        w = target_width or self.width
        vals, lens = self.device_arrays(codes.device, w)
        idx = codes.long().clamp(0, max(self.size - 1, 0))
        return vals[idx], lens[idx]


def union_ranks(a: StringDict, b: StringDict) -> Tuple[np.ndarray, np.ndarray]:
    """Each dictionary's codes mapped to ranks in the sorted union of both,
    so codes of two tables' dictionaries compare as plain int32 keys."""
    ka, kb = a._key_list(), b._key_list()
    pos = {v: i for i, v in enumerate(sorted(set(ka) | set(kb)))}
    return (np.fromiter((pos[v] for v in ka), np.int32, len(ka)),
            np.fromiter((pos[v] for v in kb), np.int32, len(kb)))


def encode_padded(
    mat: np.ndarray, lens: np.ndarray, max_size: int
) -> Optional[Tuple[np.ndarray, StringDict]]:
    """Dictionary-encode a padded (n, w) uint8 matrix: (codes int32,
    StringDict), or None when the cardinality exceeds ``max_size``. Rows
    compare as zero-padded bytes with the big-endian length appended, which
    orders an equal-prefix shorter string first and keeps embedded NULs
    exact."""
    n, w = mat.shape
    if n == 0:
        return None
    lens = lens.astype(np.int32)
    pos = np.arange(w, dtype=np.int32)
    clean = np.where(pos[None, :] < lens[:, None], mat, 0).astype(np.uint8)
    len_be = lens.astype(">i4").view(np.uint8).reshape(n, 4)
    keyed = np.concatenate([clean, len_be], axis=1)
    uniq, inv = np.unique(keyed, axis=0, return_inverse=True)
    k = uniq.shape[0]
    if k > max_size:
        return None
    dvals = np.ascontiguousarray(uniq[:, :w])
    dlens = uniq[:, w:].copy().view(">i4").reshape(k).astype(np.int32)
    return inv.astype(np.int32).reshape(n), StringDict(dvals, dlens)


def encode_objects(
    values: np.ndarray, max_len: int, max_size: int
) -> Optional[Tuple[np.ndarray, StringDict]]:
    """``encode_padded`` for an object array of str/bytes/None, without
    building the padded matrix: one hash lookup per row instead of one
    encode and one row of a multi-column sort. None encodes as b"" (its
    validity is kept apart). Gives the same codes and dictionary as
    padding then ``encode_padded``: sorting byte strings puts a proper
    prefix first, the order the zero-padded key with its length produces."""
    n = len(values)
    if n == 0:
        return None
    rows = values.tolist()
    distinct = set(rows)
    as_bytes = {
        v: (v.encode("utf-8") if isinstance(v, str) else (bytes(v) if v is not None else b""))
        for v in distinct
    }
    keys = sorted(set(as_bytes.values()))
    if max((len(b) for b in keys), default=0) > max_len:
        raise ValueError(f"string longer than max_len={max_len}")
    if len(keys) > max_size:
        return None
    rank = {b: i for i, b in enumerate(keys)}
    lut = {v: rank[b] for v, b in as_bytes.items()}
    codes = np.fromiter(map(lut.__getitem__, rows), np.int32, n)
    dvals = np.zeros((len(keys), max_len), np.uint8)
    for i, b in enumerate(keys):
        dvals[i, : len(b)] = np.frombuffer(b, np.uint8)
    dlens = np.fromiter((len(b) for b in keys), np.int32, len(keys))
    return codes, StringDict(dvals, dlens)
