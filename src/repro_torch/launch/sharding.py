"""Partition placement math for the ``graph`` axis (DESIGN.md §6), and the
LM harness's sharding rules.

Partition p of a k-way pack lives on rank ``p % g`` of a world of g ranks, at
buffer row ``partition_row(p, k, g)``. A world of 1 is the degenerate case of
the same rules (row p = partition p). The ranks are a ``launch.mesh.GraphGroup``
(the reference's mesh); ``None`` stands for a world of one.

The LM rules are the reference's: every rule is a preference list, and a
dimension is sharded on the first grid axis (or axis tuple) that divides it,
otherwise replicated. A ``PartitionSpec`` is a plain tuple here, one entry a
dimension: an axis name, a tuple of names, or ``None``. The rules take a
``launch.mesh.RankGrid`` (or anything with ``axis_names`` and ``shape``) and
key parameter leaves by the reference's tree paths (the names
``models.model.params_to_numpy`` gives).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

GRAPH_AXIS = "graph"  # the axis (torch.distributed ranks) owning graph partitions


def graph_axis_size(group=1) -> int:
    """Size of the ``graph`` axis: the number of ranks holding partitions.
    ``group`` is a ``GraphGroup``, a rank count, or ``None`` (a world of one)."""
    if group is None:
        return 1
    g = int(getattr(group, "size", group))
    if g < 1:
        raise ValueError(f"world_size must be >= 1, got {g}")
    return g


def padded_partition_count(k: int, g: int) -> int:
    """k rounded up to a multiple of the graph-axis size g. The extra
    partitions are empty (mask 0 everywhere) — k need not equal, divide, or
    exceed the rank count."""
    return ((k + g - 1) // g) * g


def partition_device(p: int, g: int) -> int:
    """Round-robin assignment: partition p lives on graph-axis position p % g."""
    return p % g


def partition_row(p: int, k: int, g: int) -> int:
    """Buffer row of partition p in the device-major packed layout.

    Rank d holds the contiguous row block [d·m, (d+1)·m) with m = k_pad/g;
    storing partition p at row (p % g)·m + p // g therefore realizes the
    round-robin assignment device(p) = p % g. With g = 1 this is the identity
    (row p = partition p), which is exactly the single-device pack_ordered
    layout.
    """
    m = padded_partition_count(k, g) // g
    return (p % g) * m + p // g


def row_partition(r: int, k: int, g: int) -> int:
    """Inverse of partition_row. May return p >= k: that row is a padding
    partition (empty, masked)."""
    m = padded_partition_count(k, g) // g
    return (r % m) * g + r // m


def device_process_map(group) -> np.ndarray:
    """(g,) process index of each ``graph``-axis rank. All zeros for a world
    of one (``group=None``) and for a single-process group, so one process is
    the degenerate case of the same per-process accounting."""
    if group is None:
        return np.zeros(1, dtype=np.int64)
    return np.asarray(group.processes, dtype=np.int64)


def partition_process(p: int, group) -> int:
    """Process owning partition p: the process of graph-axis rank p % g.
    Composes the round-robin partition→rank map with the group's
    rank→process map (multi-host runs: launch/multihost.py)."""
    return int(device_process_map(group)[p % graph_axis_size(group)])


def edges_spec() -> tuple:
    """(k_pad, E_max, 2) packed edge buffer: partitions over the graph axis."""
    return (GRAPH_AXIS, None, None)


def mask_spec() -> tuple:
    """(k_pad, E_max) validity mask: same leading-axis sharding as edges."""
    return (GRAPH_AXIS, None)


def vertex_spec() -> tuple:
    """(V,) vertex state (degrees, ranks, labels): replicated — every rank
    scatters into its own copy and the GAS combine is an all-reduce."""
    return ()


def engine_shardings(mesh=None) -> tuple:
    """The specs of (edges, mask, degrees) of a sharded engine pack."""
    return edges_spec(), mask_spec(), vertex_spec()


# ----------------------------------------------------------- the LM harness
def _sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def P(*dims) -> tuple:
    """A spec, with entries normalised as ``jax.sharding.PartitionSpec``
    normalises them: a tuple of one name is that name."""
    return tuple((d[0] if len(d) == 1 else None if not d else d) if isinstance(d, tuple) else d for d in dims)


def _axes_size(mesh, axes) -> int:
    sizes = _sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    return int(math.prod(sizes[a] for a in axes))


def _shard_if_divisible(mesh, dim: int, axes) -> Optional[object]:
    if axes is None:
        return None
    if dim % _axes_size(mesh, axes) == 0:
        return axes
    return None


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's or array's, or a ``(shape, dtype)`` pair's."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return tuple(leaf[0])


def map_with_path(fn, tree: dict, prefix=()) -> dict:
    return {k: map_with_path(fn, v, prefix + (k,)) if isinstance(v, dict) else fn(prefix + (k,), v)
            for k, v in tree.items()}


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def param_spec(mesh, path: tuple, shape: tuple) -> tuple:
    """The spec of a parameter leaf, keyed on its tree path's names."""
    names = [str(getattr(p, "key", getattr(p, "name", p))) for p in path]
    leaf = names[-1]
    in_layers = "layers" in names or "encoder" in names
    m = "model"

    def spec(*dims):
        return P(*dims)

    if leaf == "embed":  # (V, D) — shard vocab
        return spec(_shard_if_divisible(mesh, shape[0], m), None)
    if leaf == "lm_head":  # (D, V)
        return spec(None, _shard_if_divisible(mesh, shape[1], m))
    if leaf in ("final_norm", "enc_final_norm"):
        return spec(None)
    L = 1 if in_layers else 0  # layer-stacked leaves carry a leading L dim

    def stacked(*dims):
        return P(*(([None] * L) + list(dims)))

    if leaf in ("wq", "wk", "wv"):  # (L, D, H, hd) — shard the head axis only
        return stacked(None, _shard_if_divisible(mesh, shape[-2], m), None)
    if leaf == "wo":  # (L, H, hd, D)
        return stacked(_shard_if_divisible(mesh, shape[-3], m), None, None)
    if leaf in ("bq", "bk", "bv"):  # (L, H, hd)
        return stacked(_shard_if_divisible(mesh, shape[-2], m), None)
    if leaf in ("q_norm", "k_norm", "ln1", "ln2", "ln_cross", "fuse_attn", "fuse_ssm", "out_norm"):
        return stacked(None)
    if leaf == "router":  # (L, D, E) — replicated (tiny, avoids gather)
        return stacked(None, None)
    if leaf in ("w1", "w3"):
        if len(shape) == 2 + L:  # dense MLP (L, D, F)
            return stacked(None, _shard_if_divisible(mesh, shape[-1], m))
        # MoE (L, E, D, F): expert-parallel over the model axis
        return stacked(_shard_if_divisible(mesh, shape[-3], m), None, None)
    if leaf == "w2":
        if len(shape) == 2 + L:  # (L, F, D)
            return stacked(_shard_if_divisible(mesh, shape[-2], m), None)
        return stacked(_shard_if_divisible(mesh, shape[-3], m), None, None)
    if leaf == "in_proj":  # SSD: replicated on model (split offsets are static)
        return stacked(None, None)
    if leaf in ("conv_w", "a_log", "dt_bias", "d_skip"):
        return stacked(*([None] * (len(shape) - L)))
    if leaf == "out_proj":  # (L, di, D)
        return stacked(None, None)
    return tuple([None] * len(shape))


def params_shardings(mesh, params: dict) -> dict:
    """The spec of every leaf of a parameter tree (nested dicts)."""
    return map_with_path(lambda path, leaf: param_spec(mesh, path, _shape(leaf)), params)


def opt_state_spec(mesh, path: tuple, shape: tuple) -> tuple:
    """ZeRO-1: optimizer moments shard like the param but additionally over the
    data axis on the first already-unsharded dimension that divides."""
    dims = list(param_spec(mesh, path, shape))
    dims += [None] * (len(shape) - len(dims))
    dp = batch_axes(mesh)
    for i, d in enumerate(dims):
        if d is None and shape[i] % _axes_size(mesh, dp) == 0:
            dims[i] = dp if len(dp) > 1 else dp[0]
            break
    return P(*dims)


def batch_spec(mesh, batch_size: int) -> tuple:
    ba = batch_axes(mesh)
    ax = _shard_if_divisible(mesh, batch_size, ba)
    if ax is None and len(ba) > 1:  # try the inner data axis alone
        ax = _shard_if_divisible(mesh, batch_size, ba[-1])
    return P(ax)


def batch_shardings(mesh, batch_shapes: dict) -> dict:
    out = {}
    for k, leaf in batch_shapes.items():
        shape = _shape(leaf)
        out[k] = P(*batch_spec(mesh, shape[0]), *([None] * (len(shape) - 1)))
    return out


def cache_spec(mesh, key: str, shape: tuple, *, seq_shard: bool) -> tuple:
    """KV-cache specs: (L, B, Hkv, S, hd). Batch over data axes when it
    divides; sequence over the model axis for SP decode; SSM state over batch."""
    ba = batch_axes(mesh)
    if key == "pos":
        return ()
    if key in ("k", "v", "cross_k", "cross_v"):
        l, b, hkv, s, hd = shape
        bax = _shard_if_divisible(mesh, b, ba)
        seq_axes = None
        if seq_shard:
            if bax is None:
                # batch unshardable (long_500k): put the sequence over everything
                cand = tuple(list(ba) + ["model"])
                seq_axes = _shard_if_divisible(mesh, s, cand) or _shard_if_divisible(mesh, s, "model")
            else:
                seq_axes = _shard_if_divisible(mesh, s, "model")
        return P(None, bax, None, seq_axes, None)
    if key in ("ssm_state", "conv_state"):
        b = shape[1]
        return P(None, _shard_if_divisible(mesh, b, ba), *([None] * (len(shape) - 2)))
    return tuple([None] * len(shape))


def cache_shardings(mesh, cache: dict, *, seq_shard: bool) -> dict:
    """The spec of every leaf of a cache (``"pos"`` included, a scalar)."""
    return {k: cache_spec(mesh, k, _shape(v) if k != "pos" else (), seq_shard=seq_shard) for k, v in cache.items()}


def cache_seq_axes(mesh, batch_size: int) -> tuple:
    """Axes used for the cache sequence dim in SP decode (must mirror cache_spec)."""
    ba = batch_axes(mesh)
    if batch_size % _axes_size(mesh, ba) == 0:
        return ("model",)
    return tuple(list(ba) + ["model"])


def shard_shape(mesh, shape: tuple, spec: tuple) -> tuple:
    """The per-rank block of a ``shape`` array laid out by ``spec``: each
    sharded dimension divided by its axes' product."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // (1 if a is None else _axes_size(mesh, a)) for d, a in zip(shape, spec))
