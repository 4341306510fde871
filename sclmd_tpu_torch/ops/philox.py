"""Philox4x32-10 in plain torch: the CPU twin of the random draws of
kernels K3 and K3b (``csrc/noise_synth.cu``).

The generator is Random123's Philox4x32 with ten rounds (Salmon et al.,
SC'11): a 128-bit counter (c0, c1, c2, c3) and a 64-bit key (k0, k1) give
four 32-bit words. The words are held in int64 tensors masked to 32 bits,
because torch on the CPU has no uint32 arithmetic, and each 32 x 32-bit
product is taken in 16-bit halves, because the full product overflows
int64. Kernel and twin therefore draw the same integers, and the
uniforms made from them are exact functions of the integers, so they
agree bitwise.

The schedule (the kernel's and the twin's):

* key: two words of ``splitmix64(splitmix64(seed) ^ stream)`` (low word
  k0, high word k1) for an ensemble seed and a stream; the stream is the
  bath index for the noise and the number of baths for the thermal
  start;
* counter of element e of trajectory j: (e // 4, 0, j, 0); word e % 4 of
  the block belongs to element e;
* uniform of a word x: ((x >> 8) | 1) * 2^-24, an odd multiple of 2^-24
  in [2^-24, 1 - 2^-24], exact in float32, never 0 or 1;
* normals (Box-Muller on the words' pairs): with u_a the uniform of word
  a, elements 4b and 4b+1 are r01 cos(2 pi u1), r01 sin(2 pi u1), and
  4b+2, 4b+3 are r23 cos(2 pi u3), r23 sin(2 pi u3), where
  r01 = sqrt(-2 ln u0) and r23 = sqrt(-2 ln u2).

The card computes the normals in float32 (``logf``, ``sincospif``), the
twin in float64: their integers and uniforms are equal, their normals
differ by float32 rounding.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10
_MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_key(seed: int, stream: int) -> tuple:
    """The two key words (k0, k1) of an ensemble seed and a stream."""
    k = splitmix64(splitmix64(int(seed)) ^ int(stream))
    return k & M32, k >> 32


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) words of the 64-bit product of the constant ``m`` and the
    32-bit words ``x`` (int64), through 16-bit halves of ``x``."""
    pl = m * (x & 0xFFFF)                 # < 2^48
    ph = m * (x >> 16)                    # < 2^48
    s = ((ph & 0xFFFF) << 16) + pl        # < 2^49
    return (ph >> 16) + (s >> 32), s & M32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counters given as int64 tensors (or ints) holding
    32-bit words; returns the four output words as int64 tensors."""
    dev = next((v.device for v in (c0, c1, c2, c3) if torch.is_tensor(v)),
               None)
    c = [torch.as_tensor(v, dtype=torch.int64, device=dev)
         for v in (c0, c1, c2, c3)]
    c0, c1, c2, c3 = torch.broadcast_tensors(*c)
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & M32
            k1 = (k1 + PHILOX_W1) & M32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _blocks(seed: int, stream: int, lo: int, hi: int, n: int, device):
    """The Philox words of the first ``n`` elements of trajectories
    [lo, hi): an int64 (hi-lo, n) tensor, word e % 4 of block e // 4."""
    k0, k1 = stream_key(seed, stream)
    nblk = -(-n // 4)
    b = torch.arange(nblk, dtype=torch.int64, device=device)[None, :]
    j = torch.arange(lo, hi, dtype=torch.int64, device=device)[:, None]
    words = torch.stack(philox4x32(b, 0, j, 0, k0, k1), dim=-1)
    return words.reshape(hi - lo, 4 * nblk)[:, :n]


def uniform_of(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """((x >> 8) | 1) * 2^-24 of 32-bit words held in int64."""
    return ((words >> 8) | 1).to(dtype) * (2.0 ** -24)


def uniforms(seed: int, stream: int, lo: int, hi: int, n: int,
             device="cpu", dtype=torch.float32) -> torch.Tensor:
    """(hi-lo, n) uniforms of the schedule (K3b's twin)."""
    return uniform_of(_blocks(seed, stream, lo, hi, n, device), dtype)


def normals(seed: int, stream: int, lo: int, hi: int, n: int,
            device="cpu") -> torch.Tensor:
    """(hi-lo, n) float64 standard normals of the schedule (K3's draw,
    before the scale by std)."""
    words = _blocks(seed, stream, lo, hi, 4 * -(-n // 4), device)
    u = uniform_of(words.reshape(hi - lo, -1, 2, 2), torch.float64)
    r = torch.sqrt(-2.0 * torch.log(u[..., 0]))
    th = 2.0 * math.pi * u[..., 1]
    z = torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=-1)
    return z.reshape(hi - lo, -1)[:, :n]
