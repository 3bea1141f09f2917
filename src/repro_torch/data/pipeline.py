"""Deterministic synthetic token pipeline, CEP-sharded over hosts.

Every (step, global sample index, position) maps to a token via a stateless
mix hash, so any host can materialize exactly its shard of the global batch —
no data service required. Host shards are CEP chunks of the sample index
space: when the host count changes k→k±x, cep.scale_plan moves only the
boundary ranges (paper Thm. 2), and training resumes deterministically from
(step, k_new).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import cep
from ..core.baselines import mix_hash


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


NOISE_DENOM = 8  # 1/8 of positions are random; the rest follow the chain


def _tokens(dc: DataConfig, step: int, sample_ids: np.ndarray) -> np.ndarray:
    """(len(sample_ids), seq_len+1) int32 deterministic *learnable* stream.

    A noisy affine Markov chain: t_{i+1} = (a·t_i + c) mod V with probability
    7/8, else a fresh hash draw — stateless per (seed, step, sample, pos), so
    any host shard reproduces exactly its rows, yet a model can learn the
    transition and the loss visibly decreases.
    """
    n = sample_ids.shape[0]
    s = dc.seq_len + 1
    pos = np.arange(s, dtype=np.uint64)[None, :]
    sid = sample_ids.astype(np.uint64)[:, None]
    # Same stateless draw as every other deterministic stream in the repo:
    # (seed, step, sample, pos) through core.baselines.mix_hash.
    h = mix_hash(dc.seed, step, sid, pos)
    rand_tok = (h % np.uint64(dc.vocab_size)).astype(np.int64)
    is_noise = (h >> np.uint64(32)) % np.uint64(NOISE_DENOM) == 0
    a = 7 if dc.vocab_size % 7 else 11
    out = np.empty((n, s), dtype=np.int64)
    out[:, 0] = rand_tok[:, 0]
    for i in range(1, s):
        chain = (out[:, i - 1] * a + 3) % dc.vocab_size
        out[:, i] = np.where(is_noise[:, i], rand_tok[:, i], chain)
    return out.astype(np.int32)


def global_batch(dc: DataConfig, step: int) -> dict:
    toks = _tokens(dc, step, np.arange(dc.global_batch))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def host_batch(dc: DataConfig, step: int, k_hosts: int, host: int) -> dict:
    """This host's CEP chunk of the step's global batch."""
    bounds = cep.chunk_bounds(dc.global_batch, k_hosts)
    ids = np.arange(int(bounds[host]), int(bounds[host + 1]))
    toks = _tokens(dc, step, ids)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "sample_ids": ids}


def rescale_moves(dc: DataConfig, k_old: int, k_new: int):
    """Sample-range migration plan for an elastic data-shard rescale."""
    return cep.scale_plan(dc.global_batch, k_old, k_new)
