"""Deterministic synthetic token streams (port of
``repro.data.synthetic``).

Batch ``i`` is a pure function of ``(seed, i, shard)``: any step of any
shard can be rebuilt after a restart with no loader state to restore.
The draws come from a CPU ``torch.Generator`` seeded with
:func:`stream_seed`, so they differ from the reference's threefry
stream (tests that compare the two packages inject their batches).

Tokens are uniform in ``[0, vocab)``, as the reference draws them: the
reference's comment calls its stream "Markov-ish", but its
``randint`` is uniform, so the LM loss cannot fall far below
``ln(vocab)``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234


def _splitmix64(x: int) -> int:
    """One round of SplitMix64 (Steele, Lea and Flood, 2014) on a 64-bit
    integer."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, step: int, shard: int) -> int:
    """The generator seed of ``(seed, step, shard)``: the seed hashed,
    then the step folded in and hashed, then the shard, as the
    reference folds the step and then the shard into its key.  Each
    value enters as its 64-bit two's complement."""
    h = _splitmix64(seed & _MASK64)
    h = _splitmix64(h ^ (step & _MASK64))
    return _splitmix64(h ^ (shard & _MASK64))


def batch_at(cfg: DataConfig, step: int,
             shard: Tuple[int, int] = (0, 1)) -> dict:
    """``{"tokens", "labels"}`` for ``step``, int32 ``[local, seq_len]``
    CPU tensors; ``shard=(k, n)`` gives the k-th of n per-host slices of
    the global batch.  ``labels`` are ``tokens`` shifted by one."""
    k, n = shard
    assert cfg.global_batch % n == 0
    local = cfg.global_batch // n
    gen = torch.Generator().manual_seed(stream_seed(cfg.seed, step, k))
    base = torch.randint(0, cfg.vocab, (local, cfg.seq_len + 1),
                         generator=gen, dtype=torch.int64).to(torch.int32)
    return {"tokens": base[:, :-1], "labels": base[:, 1:]}


def iterate(cfg: DataConfig, start_step: int = 0,
            shard: Tuple[int, int] = (0, 1)) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step, shard)
        step += 1
