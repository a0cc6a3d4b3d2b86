"""Rust `rand` 0.9 `StdRng` emulation (ChaCha12) for spawn-sequence parity.

The reference seeds `StdRng::seed_from_u64(0)` and draws `random_range`
integers while spawning Wang tiles (wangtile.rs:55,1746-1752) and
`random_range(-1.0..=1.0)` floats for the Random height map
(wangtile.rs:385). PARITY.md #1 documented the numpy default_rng(0) stand-in
as the last algorithmic deviation; this module closes it behind
`UserData.rng_mode = "stdrng"`.

Composition (all public algorithms):
- `seed_from_u64`: rand_core 0.9's SplitMix64 expansion of the u64 seed
  into the 32-byte ChaCha key (rand_core/src/lib.rs `SeedableRng::
  seed_from_u64`).
- ChaCha12 block function: RFC 8439's ChaCha quarter-round/state layout
  with 12 rounds, rand_chacha 0.9's stream layout: key = seed, 64-bit
  block counter in words 12-13 starting at 0, stream id (words 14-15) = 0.
  Output words are served in order; `next_u64` = two consecutive words
  (low word first). The 20-round core is validated against the
  `cryptography` package's ChaCha20 in tests/test_stdrng.py; the 12-round
  variant only changes the round count.
- `random_range(0..n)` on integers: rand 0.9 `UniformInt::
  sample_single_inclusive` — Canon's method (widening multiply; one
  conditional extra sample for bias correction).
- `random_range(-1.0..=1.0)` on f32: rand 0.9 `UniformFloat::
  sample_single_inclusive` — value-range scaling of a 24-bit mantissa
  sample: x * scale + low, with scale shrunk until the maximum sample
  stays inside the inclusive bounds.

The WASM build (the reference's primary target, .cargo/config.toml) has
32-bit `usize`, so `random_range(0..usize)` consumes ONE u32 draw; the
native build consumes a u64 (two words). `word_width` selects it
("wasm32" default, matching the shipped renderer).
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def _splitmix64_stream(seed: int):
    state = seed & _M64
    while True:
        state = (state + 0x9E3779B97F4A7C15) & _M64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        yield (z ^ (z >> 31)) & _M64


def seed_from_u64(seed: int) -> bytes:
    """rand_core 0.9 SeedableRng::seed_from_u64 -> 32-byte ChaCha key."""
    gen = _splitmix64_stream(seed)
    out = b"".join(next(gen).to_bytes(8, "little") for _ in range(4))
    return out


def _rotl32(x, n):
    return ((x << n) | (x >> (32 - n))) & _M32


def _quarter_round(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & _M32
    s[d] = _rotl32(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _M32
    s[b] = _rotl32(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & _M32
    s[d] = _rotl32(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _M32
    s[b] = _rotl32(s[b] ^ s[c], 7)


def chacha_block(key: bytes, counter: int, nonce: bytes = b"\x00" * 8,
                 rounds: int = 12) -> list[int]:
    """One ChaCha block -> 16 output u32 words.

    rand_chacha layout: constants | key (8 words LE) | 64-bit counter
    (words 12-13, low first) | 64-bit stream id (words 14-15)."""
    state = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
    state += [int.from_bytes(key[i : i + 4], "little") for i in range(0, 32, 4)]
    state += [counter & _M32, (counter >> 32) & _M32]
    state += [int.from_bytes(nonce[i : i + 4], "little") for i in range(0, 8, 4)]
    work = list(state)
    for _ in range(rounds // 2):
        _quarter_round(work, 0, 4, 8, 12)
        _quarter_round(work, 1, 5, 9, 13)
        _quarter_round(work, 2, 6, 10, 14)
        _quarter_round(work, 3, 7, 11, 15)
        _quarter_round(work, 0, 5, 10, 15)
        _quarter_round(work, 1, 6, 11, 12)
        _quarter_round(work, 2, 7, 8, 13)
        _quarter_round(work, 3, 4, 9, 14)
    return [(w + s) & _M32 for w, s in zip(work, state)]


class StdRng:
    """ChaCha12 word stream + rand 0.9 range sampling.

    word_width: "wasm32" (usize = u32, one word per integer draw — the
    reference's shipped WASM build) or "native64" (usize = u64, two words).
    """

    def __init__(self, seed: int = 0, word_width: str = "wasm32"):
        self.key = seed_from_u64(seed)
        self.word_width = word_width
        self._counter = 0
        self._buf: list[int] = []

    # -- word stream ------------------------------------------------- #
    def next_u32(self) -> int:
        if not self._buf:
            self._buf = chacha_block(self.key, self._counter)
            self._counter += 1
        return self._buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    # -- integer ranges (Canon's method, uniform_int.rs) -------------- #
    def _range_u32(self, n: int) -> int:
        """sample_single_inclusive(0, n-1) with u32 samples."""
        rng = n & _M32  # range size
        if rng == 0:
            return self.next_u32()
        x = self.next_u32()
        m = x * rng  # widening multiply: hi = m >> 32, lo = m & _M32
        result, lo_order = m >> 32, m & _M32
        if lo_order > ((-rng) & _M32):
            y = self.next_u32()
            new_hi = (y * rng) >> 32
            if lo_order + new_hi > _M32:
                result += 1
        return result

    def _range_u64(self, n: int) -> int:
        rng = n & _M64
        if rng == 0:
            return self.next_u64()
        x = self.next_u64()
        m = x * rng
        result, lo_order = m >> 64, m & _M64
        if lo_order > ((-rng) & _M64):
            y = self.next_u64()
            new_hi = (y * rng) >> 64
            if lo_order + new_hi > _M64:
                result += 1
        return result

    def random_range_usize(self, n: int) -> int:
        """`rng.random_range(0..n)` for usize."""
        if self.word_width == "wasm32":
            return self._range_u32(n)
        return self._range_u64(n)

    # -- f32 ranges (uniform_float.rs sample_single_inclusive) -------- #
    def random_range_f32_inclusive(self, low: float, high: float) -> float:
        """`rng.random_range(low..=high)` for f32: value-range scaling of
        a 24-bit-precision sample in [0, 1); the scale is stepped toward
        zero until scale * max_sample + low <= high."""
        f32 = np.float32
        low = f32(low)
        high = f32(high)
        max_sample = f32(np.float32(0xFFFFFF) * f32(2.0) ** -24)  # (2^24-1)/2^24
        scale = f32((high - low) / max_sample)
        while True:
            mx = f32(scale * max_sample + low)
            if mx <= high:
                break
            # next_down(scale)
            scale = f32(np.nextafter(scale, f32(0.0)))
        value = f32(np.float32(self.next_u32() >> 8) * f32(2.0) ** -24)
        return float(f32(scale * value + low))


class NumpyCompatRng:
    """Adapter giving the numpy-based engine draws the same call surface."""

    def __init__(self, rng: StdRng):
        self.std = rng

    def integers(self, low: int, high: int) -> int:
        assert low == 0
        return self.std.random_range_usize(high)

    def uniform(self, low: float, high: float, size: int) -> np.ndarray:
        return np.asarray(
            [self.std.random_range_f32_inclusive(low, high) for _ in range(size)],
            np.float32,
        )
