"""Bit-exact torch twin of the ``jax.random`` threefry calls the render path uses.

The frame's primary-ray jitter and the megakernel's trace seed derive from
``jax.random`` keys in the reference (``PRNGKey`` -> ``fold_in`` -> ``split``
-> ``uniform``, then ``key_data``). Reproducing those bits exactly is what
lets the port render the same pixels as the reference, so this module
re-implements threefry2x32 and the key schedule of jax's default
``jax_threefry_partitionable=True`` mode (jax/_src/prng.py:
``threefry_seed``, ``iota_2x32_shape``, ``_threefry_split_foldlike``,
``_threefry_fold_in``, ``_threefry_random_bits_partitionable``; and the
mantissa trick of ``jax/_src/random.py:_uniform``).

PyTorch has little uint32 arithmetic on the CPU, so 32-bit words live in
int64 tensors masked with ``& 0xFFFFFFFF`` after every operation that can
carry past bit 31. A key is an int64 tensor of shape ``[..., 2]``; every
function here broadcasts over leading key dimensions, which takes the place
of ``jax.vmap`` over keys.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_KEY_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _as_words(value, device) -> torch.Tensor:
    """An int or integer tensor as uint32 words held in int64 (two's
    complement for negatives, as ``astype(uint32)`` gives)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int64) & MASK32
    return torch.tensor(int(value) & MASK32, dtype=torch.int64, device=device)


def _rotate_left(x: torch.Tensor, bits: int) -> torch.Tensor:
    return ((x << bits) | (x >> (32 - bits))) & MASK32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block function, elementwise with broadcasting.

    Same rounds and key injections as ``_threefry2x32_lowering``.
    """
    ks = (k1, k2, k1 ^ k2 ^ _KEY_PARITY)
    v0 = (x1 + ks[0]) & MASK32
    v1 = (x2 + ks[1]) & MASK32
    for group in range(5):
        for bits in _ROTATIONS[group % 2]:
            v0 = (v0 + v1) & MASK32
            v1 = _rotate_left(v1, bits) ^ v0
        v0 = (v0 + ks[(group + 1) % 3]) & MASK32
        v1 = (v1 + ks[(group + 2) % 3] + (group + 1)) & MASK32
    return v0, v1


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:  # noqa: N802 - jax's name
    """``jax.random.PRNGKey`` for a 32-bit seed: the words ``(0, seed)``."""
    return torch.stack(
        [torch.zeros((), dtype=torch.int64, device=device), _as_words(seed, device)]
    )


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash ``data`` (taken as uint32) into ``key``.

    ``data`` may be an int (negative included) or an integer tensor, which
    broadcasts against the key's leading dimensions.
    """
    words = _as_words(data, key.device)
    k1, k2 = key[..., 0], key[..., 1]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(words), words)
    b1, b2 = torch.broadcast_tensors(b1, b2)
    return torch.stack([b1, b2], dim=-1)


def _counts(size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``iota_2x32_shape``: a flat uint64 iota as (high, low) words."""
    flat = torch.arange(size, dtype=torch.int64, device=device)
    return flat >> 32, flat & MASK32


def _block_bits(key: torch.Tensor, shape: tuple[int, ...]):
    """threefry2x32 of each key over the flat counter of ``shape``."""
    size = math.prod(shape)
    hi, lo = _counts(size, key.device)
    k1 = key[..., 0, None]
    k2 = key[..., 1, None]
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    lead = key.shape[:-1]
    return b1.reshape(*lead, *shape), b2.reshape(*lead, *shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., num, 2]`` new keys."""
    b1, b2 = _block_bits(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32-bit random words of ``shape`` for each key (``[..., *shape]``)."""
    b1, b2 = _block_bits(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32, on ``[0, 1)``.

    The top 23 bits become the mantissa of a float in ``[1, 2)``, and 1 is
    subtracted, exactly as ``jax/_src/random.py:_uniform`` does.
    """
    bits = random_bits(key, shape)
    one_bits = 0x3F800000  # float32 1.0
    mantissa = ((bits >> 9) | one_bits).to(torch.int32)
    return mantissa.view(torch.float32) - 1.0


def key_data(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.key_data`` of a raw key: its uint32 words (as int64)."""
    return key


def as_int32(word: torch.Tensor) -> torch.Tensor:
    """A uint32 word reinterpreted as int32 (``astype(int32)`` in jax)."""
    return ((word & MASK32) ^ 0x80000000) - 0x80000000
