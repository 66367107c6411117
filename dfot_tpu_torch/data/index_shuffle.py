# Copyright 2023 Google LLC
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     https://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.
"""grain's index permutation, in Python, and the epoch order around it.

A transcription of the permutation that grain's ``IndexSampler`` shuffles
with (``grain::random::index_shuffle``, the compiled module that grain's
``ShuffleMapDataset`` calls): a Simon-style Feistel cipher on a block of
2w bits, the smallest even width of at least 16 bits that holds
``max_index``, its round keys ``std::seed_seq{seed}.generate``d,
cycle-walking until the image falls in [0, max_index]. (grain also ships a
pure-Python ``index_shuffle`` built on MD5; it gives another permutation,
which its sampler does not use.) With it, ``EpochOrder`` gives the record
order of ``IndexSampler(num_records, NoSharding(), shuffle, num_epochs=1,
seed)``, the order the JAX package's ``GrainDataLoader`` loads in.
"""

from __future__ import annotations

import math
from typing import List

__all__ = ["index_shuffle", "EpochOrder"]

_MASK32 = 0xFFFFFFFF
_MIN_BLOCK_BITS = 16


def _seed_seq(seed: int, n: int) -> List[int]:
    """``std::seed_seq{seed}.generate`` of ``n`` 32-bit words."""
    b = [0x8B8B8B8B] * n
    s = 1
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def T(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * T(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n])) & _MASK32
        if k == 0:
            r2 = (r1 + s) & _MASK32
        elif k <= s:
            r2 = (r1 + k % n + seed) & _MASK32
        else:
            r2 = (r1 + k % n) & _MASK32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _MASK32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _MASK32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * T((b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _MASK32)) & _MASK32
        r4 = (r3 - k % n) & _MASK32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def _rotl(x: int, r: int, w: int, mask: int) -> int:
    return ((x << r) & mask) | (x >> (w - r))


def _round(x: int, w: int, mask: int) -> int:
    return (_rotl(x, 1, w, mask) & _rotl(x, 8, w, mask)) ^ _rotl(x, 2, w, mask)


def _encrypt(value: int, keys: List[int], w: int, mask: int) -> int:
    left, right = (value >> w) & mask, value & mask
    for i in range(0, len(keys), 2):
        left ^= _round(right, w, mask) ^ keys[i]
        right ^= _round(left, w, mask) ^ keys[i + 1]
    return (left << w) | right


def _permutation(max_index: int, seed: int, rounds: int):
    """index -> its image under grain's permutation of [0, max_index]."""
    if max_index == 0:
        return lambda index: 0
    bits = math.ceil(math.log2(float(max_index)))
    w = max(bits + bits % 2, _MIN_BLOCK_BITS) // 2
    mask = (1 << w) - 1
    keys = [k & mask for k in _seed_seq(seed & _MASK32, rounds)]

    def image(index: int) -> int:
        x = index
        while True:  # cycle-walk back into [0, max_index]
            x = _encrypt(x, keys, w, mask)
            if x <= max_index:
                return x

    return image


def index_shuffle(index: int, max_index: int, seed: int, rounds: int = 4) -> int:
    """The position of ``index`` in grain's pseudorandom permutation of
    [0, max_index] under a 32-bit ``seed``; ``rounds`` is even and >= 4."""
    return _permutation(max_index, seed, rounds)(index)


class EpochOrder:
    """The record keys of one epoch of grain's ``IndexSampler`` without
    sharding (``num_epochs=1``): the dataset's order, or its shuffle under
    ``seed``, each key computed when it is read."""

    def __init__(self, num_records: int, shuffle: bool, seed: int):
        if num_records <= 0:
            raise ValueError(f"a sampler needs records, got {num_records}")
        if shuffle and (seed < 0 or seed.bit_length() > 32):
            raise ValueError("the shuffle seed must be a non-negative 32-bit integer")
        self.num_records = num_records
        self._image = _permutation(num_records - 1, seed, 4) if shuffle else None

    def __len__(self) -> int:
        return self.num_records

    def __getitem__(self, i: int) -> int:
        if not 0 <= i < self.num_records:
            raise IndexError(i)
        return i if self._image is None else self._image(i)

    def __iter__(self):
        return (self[i] for i in range(self.num_records))
