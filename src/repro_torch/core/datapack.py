"""Padding helpers kept from the JAX package's ``core/datapack.py``.

Only the two functions the configs need.  The vocab rule keeps the
reference's value (a multiple of 16 model shards x 128 lanes) so both
packages declare identical parameter shapes.
"""

from __future__ import annotations


def round_up(x: int, multiple: int) -> int:
    if multiple <= 0:
        raise ValueError("multiple must be positive")
    return -(-x // multiple) * multiple


def padded_vocab(vocab: int, model_shards: int = 16, lanes: int = 128) -> int:
    """Vocab padded to a multiple of ``model_shards * lanes``."""
    return round_up(vocab, model_shards * lanes)
