"""Fixed-size bitmasks over uint64 words.

Reference: ``crates/vdb/src/bitmask.rs`` — ``BitMask<SIZE>`` over
``[usize; SIZE/64]`` with get/set/count and a set-bit iterator. The doc
tests there (bitmask.rs:83-96) are the behavioural oracle for
:meth:`BitMask.iter_set_bits`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BitMask"]


class BitMask:
    """A SIZE-bit mask stored as ceil(SIZE/64) uint64 words.

    Bit ``i`` lives in ``words[i // 64]`` at position ``i % 64``
    (little-endian bit order, matching the reference and the GLSL
    two-u32 fallback in ``primary/hit.rint:13-16``).
    """

    __slots__ = ("size", "words")

    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("BitMask size must be positive")
        self.size = size
        self.words = np.zeros((size + 63) // 64, dtype=np.uint64)

    def get(self, index: int) -> bool:
        self._check(index)
        return bool((int(self.words[index >> 6]) >> (index & 63)) & 1)

    def set(self, index: int, value: bool) -> None:
        self._check(index)
        word = int(self.words[index >> 6])
        bit = 1 << (index & 63)
        self.words[index >> 6] = np.uint64(word | bit if value else word & ~bit)

    def count_ones(self) -> int:
        return int(sum(int(w).bit_count() for w in self.words))

    def is_empty(self) -> bool:
        return not self.words.any()

    def clear(self) -> None:
        self.words[:] = 0

    def iter_set_bits(self):
        """Yield indices of set bits in ascending order (bit-trick iterator,
        reference bitmask.rs:43-77)."""
        for wi, w in enumerate(self.words):
            w = int(w)
            base = wi << 6
            while w:
                low = w & -w
                yield base + low.bit_length() - 1
                w ^= low
            # bits beyond `size` in the last word are never set

    def as_u64(self) -> int:
        """The mask as a python int (only valid for size <= 64)."""
        if self.size > 64:
            raise ValueError("mask wider than 64 bits")
        return int(self.words[0])

    def set_u64(self, value: int) -> None:
        if self.size > 64:
            raise ValueError("mask wider than 64 bits")
        self.words[0] = np.uint64(value & 0xFFFFFFFFFFFFFFFF)

    def _check(self, index: int) -> None:
        if not (0 <= index < self.size):
            raise IndexError(f"bit {index} out of range for BitMask({self.size})")

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitMask)
            and self.size == other.size
            and np.array_equal(self.words, other.words)
        )

    def __repr__(self) -> str:
        return f"BitMask({self.size}, popcount={self.count_ones()})"
