"""Per-lane sampling at temperature > 0 for the decode head.

The reference samples inline in its decode head
(``repro.pipeline.pipeline``, ``jax.random.categorical`` keyed by
``PRNGKey(seed)`` per lane).  jax's threefry stream does not exist in
PyTorch, so the port keeps the reference's *distribution*, not its bits:

* **Counter-based uniforms.** Philox4x32-10 keyed by the lane's int32 seed
  (key ``(seed, 0)``), with the vocabulary index as the counter
  ``(v, 0, 0, 0)``; the first 32-bit output word becomes a float32 uniform
  the way jax's ``uniform`` does (the high 23 bits as the mantissa of a
  number in [1, 2), minus 1, then ``[tiny, 1)``).  Written in plain tensor
  ops on int64 with explicit 32-bit masks (products split at 16 bits, so
  nothing overflows), the words are bitwise the same on the CPU and the
  card.
* **Gumbel-max.** ``argmax(logits / T + g)`` with ``g = -log(-log(u))`` —
  what ``jax.random.categorical`` computes — draws from
  ``softmax(logits / T)``.

A lane's draw depends only on its seed and its logits, so lanes are
independent and a replay with the same seeds repeats bit for bit.  The
returned log-probability is the *untempered* ``log_softmax(logits)`` at
the chosen id, as the reference returns it.
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF
# Philox4x32 round multipliers and Weyl key increments (Salmon et al. 2011)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_ROUNDS = 10
_TINY = torch.finfo(torch.float32).tiny


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for int64 ``a`` in [0, 2^32) and a
    32-bit constant ``m``: the product is split at 16 bits of ``a`` so every
    partial product stays below 2^49."""
    t = (a & _MASK16) * m                       # < 2^48
    u = (a >> 16) * m + (t >> 16)               # < 2^49
    hi = u >> 16
    lo = ((u & _MASK16) << 16) | (t & _MASK16)
    return hi, lo


def philox4x32(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words.

    ``counter``: four broadcastable tensors (c0..c3); ``key``: two (k0,
    k1).  Returns the four output words (int64 in [0, 2^32))."""
    c0, c1, c2, c3 = (torch.as_tensor(c) & _MASK32 for c in counter)
    k0, k1 = (torch.as_tensor(k) & _MASK32 for k in key)
    for r in range(_ROUNDS):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(seeds: torch.Tensor, vocab: int) -> torch.Tensor:
    """[N, vocab] int64: the first Philox word of counter ``(v, 0, 0, 0)``
    under key ``(seed_n, 0)`` — the sampler's raw bits."""
    dev = seeds.device
    key0 = seeds.to(torch.int64).reshape(-1, 1)
    ctr = torch.arange(vocab, dtype=torch.int64, device=dev).reshape(1, -1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return philox4x32((ctr, zero, zero, zero), (key0, zero))[0]


def uniforms(seeds: torch.Tensor, vocab: int) -> torch.Tensor:
    """[N, vocab] float32 uniforms in [tiny, 1), from the words as jax's
    ``uniform(minval=tiny, maxval=1)`` turns bits into floats."""
    bits = (philox_words(seeds, vocab) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * (1.0 - _TINY) + _TINY, _TINY)


def perturbed(logits: torch.Tensor, seeds: torch.Tensor,
              temperature: float) -> torch.Tensor:
    """``logits / T + g`` in float32 with Gumbel noise ``g`` from the lane
    seeds: its argmax is the sample."""
    g = -torch.log(-torch.log(uniforms(seeds, logits.shape[-1])))
    return logits.float() / float(temperature) + g


def sample(logits: torch.Tensor, seeds: torch.Tensor, temperature: float):
    """(ids int32 [N], logprobs float32 [N]) for logits [N, V] and int32
    lane seeds [N]: a Gumbel-max draw from ``softmax(logits / T)`` and the
    untempered ``log_softmax(logits)`` at the drawn id."""
    ids = torch.argmax(perturbed(logits, seeds, temperature), dim=-1)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return ids.to(torch.int32), lp.gather(-1, ids[:, None])[:, 0]


def top2_gap(logits: torch.Tensor, seeds: torch.Tensor,
             temperature: float) -> torch.Tensor:
    """[N] gap between the two largest perturbed scores: where it is
    small, a last-bit difference in the logits can change the draw."""
    top2 = perturbed(logits, seeds, temperature).topk(2, dim=-1).values
    return top2[:, 0] - top2[:, 1]
