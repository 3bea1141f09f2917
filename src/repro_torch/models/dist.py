"""Distribution context of the LM harness: sequence-parallel decode over
ranks.

The reference's ``repro.models.dist`` carries a ``Distribution`` over a JAX
mesh. Here the mesh is a ``launch.mesh.RankGrid`` and each rank is one
process that holds its share of the inputs, as the reference's ``cache_spec``
lays them out:

* the batch rows of its index on the batch axes (``batch_rows``), or every
  row when ``batch_axes`` is empty;
* the slice of the KV cache's sequence axis of its index on the sequence
  axes (``seq_slice``): index = the row-major position over ``seq_axes``, as
  the reference's ``sp_decode_attention`` computes it;
* the weights whole (no tensor parallelism: ``tp_axis`` only names the axis).

``sp_decode_attention`` attends over the rank's slice in float32 and merges
the partials ``(o, m, l)``, all-gathered over the sequence axes, by the
stable log-sum-exp of the reference (``dist.py:193-197``).
``sp_cache_update`` writes a token's K/V in place on the rank that owns its
position. The reference's ``hint_*`` functions steer GSPMD's sharding
propagation; there is none here, and the layers call no hint.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..launch import multihost as MH

_CTX: Optional["Distribution"] = None


@dataclasses.dataclass(frozen=True)
class Distribution:
    mesh: object  # a launch.mesh.RankGrid
    batch_axes: tuple = ("data",)  # grid axes sharding the batch dim (() = every rank holds every row)
    seq_axes: tuple = ("model",)  # grid axes sharding the KV cache's sequence dim
    sp_decode: bool = True  # sequence-parallel decode attention on/off
    tp_axis: str = "model"

    @property
    def batch_spec(self):
        return tuple(self.batch_axes) if self.batch_axes else None

    @property
    def seq_spec(self):
        return tuple(self.seq_axes) if self.seq_axes else None

    @property
    def tp_size(self) -> int:
        return self.mesh.axis_size(self.tp_axis)

    def _index(self, axes) -> tuple[int, int]:
        """(this rank's row-major index over ``axes``, their product)."""
        coords = self.mesh.coords
        idx, n = 0, 1
        for a in axes:
            size = self.mesh.axis_size(a)
            idx = idx * size + coords[a]
            n *= size
        return idx, n

    @property
    def seq_ranks(self) -> int:
        """Ranks sharing the cache's sequence axis: the product of ``seq_axes``."""
        return self._index(self.seq_axes)[1]

    def batch_rows(self, rows: int) -> tuple[int, int]:
        """[lo, hi) of this rank's rows of a global batch of ``rows``."""
        idx, n = self._index(self.batch_axes)
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over the {n} ranks of {self.batch_axes}")
        m = rows // n
        return idx * m, (idx + 1) * m

    def seq_slice(self, length: int) -> tuple[int, int]:
        """[lo, hi) of this rank's positions of a cache of ``length``."""
        idx, n = self._index(self.seq_axes)
        if length % n:
            raise ValueError(f"a cache of {length} positions does not split over the {n} ranks of {self.seq_axes}")
        m = length // n
        return idx * m, (idx + 1) * m

    def seq_start(self, local_len: int) -> int:
        """First global position of this rank's cache slice of ``local_len``."""
        return self._index(self.seq_axes)[0] * local_len


def dp_size() -> int:
    """Product of the batch-sharding axes (1 without a distribution)."""
    dist = current()
    if dist is None or not dist.batch_axes:
        return 1
    return math.prod(dist.mesh.axis_size(a) for a in dist.batch_axes)


def current() -> Optional[Distribution]:
    return _CTX


class use_distribution:
    """``with use_distribution(dist):`` makes ``dist`` the live distribution
    (``None``: none) and restores the previous one on the way out."""

    def __init__(self, dist: Optional[Distribution]):
        self.dist = dist

    def __enter__(self) -> Optional[Distribution]:
        global _CTX
        self.prev, _CTX = _CTX, self.dist
        return self.dist

    def __exit__(self, *exc) -> bool:
        global _CTX
        _CTX = self.prev
        return False


# ------------------------------------------------------------------ SP decode
def sp_decode_attention(dist: Distribution, q, ck, cv, pos: int, *, window, softcap, scale, norm_eps=1e-6):
    """q: (B, Hq, 1, hd), this rank's rows; ck / cv: (B, Hkv, S_loc, hd), its
    slice of the cache's sequence axis. Masked partial attention over the
    slice in float32, then the partials of every rank of the sequence axes,
    merged by the stable log-sum-exp. Returns (B, Hq, 1, hd) in q's dtype."""
    b, hq, _, hd = q.shape
    hkv, s_loc = ck.shape[1], ck.shape[2]
    g = hq // hkv
    start = dist.seq_start(s_loc)
    qg = q.reshape(b, hkv, g, hd).float()
    sc = torch.matmul(qg, ck.float().transpose(-1, -2)) * scale  # (B, Hkv, G, S_loc)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    kpos = start + torch.arange(s_loc, device=q.device)
    mask = kpos <= pos
    if window is not None and window > 0:
        mask = mask & (kpos > pos - window)
    sc = torch.where(mask, sc, -1e30)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, cv.float()) / torch.clamp_min(l, 1e-30)  # (B, Hkv, G, hd)
    # One gather a sequence axis of (o | m | l) along a new tile axis, as the
    # reference gathers each axis in turn (the merge is order-free).
    parts = torch.cat([o, m, l], dim=-1)[None]  # (1, B, Hkv, G, hd + 2)
    for ax in dist.seq_axes:
        parts = MH.all_gather_rows(parts, dist.mesh.line(ax))
    mo, mm, ml = parts[..., :hd], parts[..., hd : hd + 1], parts[..., hd + 1 :]
    top = mm.amax(dim=0, keepdim=True)
    w = ml * torch.exp(mm - top)
    denom = w.sum(dim=0, keepdim=True)
    out = (mo * (w / torch.clamp_min(denom, 1e-30))).sum(dim=0)
    return out.reshape(b, hq, 1, hd).to(q.dtype)


def sp_cache_update(dist: Distribution, cache, new_kv, pos: int):
    """Write ``new_kv`` (B, Hkv, 1, hd) at global position ``pos`` into this
    rank's slice ``cache`` (B, Hkv, S_loc, hd), in place, when the slice
    holds ``pos``; any other rank's slice is left as it is. Returns ``cache``."""
    s_loc = cache.shape[2]
    off = pos - dist.seq_start(s_loc)
    if 0 <= off < s_loc:
        cache[:, :, off : off + 1] = new_kv.to(cache.dtype)
    return cache
