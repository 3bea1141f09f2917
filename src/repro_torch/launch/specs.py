"""Input specs for every (arch × shape) cell: the dry run's inputs.

The counterpart of ``repro.launch.specs``. Each leaf is a ``LeafSpec``: its
global shape, dtype, spec (``launch/sharding.py``: a tuple, one entry a
dimension) and the block one rank holds of it on the grid. Nothing is
allocated: the shapes come from ``models.model.param_shapes`` and
``cache_shapes``, and the trees keep the reference's tree paths.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models import model as M
from ..models.config import ModelConfig, ShapeSpec
from . import sharding as SH

PARAM_DTYPE = torch.bfloat16
CACHE_DTYPE = torch.bfloat16

# Micro-batch accumulation per arch for the train_4k cell (the reference's).
TRAIN_MICROBATCHES = {
    "phi-3-vision-4.2b": 4,
    "gemma3-4b": 4,
    "qwen3-8b": 8,
    "qwen2-1.5b": 2,
    "gemma2-9b": 8,
    "whisper-small": 2,
    "mamba2-1.3b": 4,
    "deepseek-moe-16b": 4,
    "granite-moe-3b-a800m": 4,
    "hymba-1.5b": 4,
}


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    shape: tuple  # global
    dtype: torch.dtype
    spec: tuple
    shard_shape: tuple  # the block one rank holds

    @property
    def shard_bytes(self) -> int:
        return math.prod(self.shard_shape) * torch.empty((), dtype=self.dtype).element_size()


def leaf(mesh, shape, dtype, spec) -> LeafSpec:
    shape = tuple(int(d) for d in shape)
    return LeafSpec(shape, dtype, SH.P(*spec), SH.shard_shape(mesh, shape, spec))


def leaves(tree):
    """Every ``LeafSpec`` of a spec tree, in the tree's order."""
    if isinstance(tree, LeafSpec):
        yield tree
        return
    for v in tree.values():
        yield from leaves(v)


def per_device_bytes(tree) -> int:
    """Bytes one rank holds of every leaf of ``tree``."""
    return sum(x.shard_bytes for x in leaves(tree))


def param_specs(cfg: ModelConfig, mesh) -> dict:
    return SH.map_with_path(
        lambda path, sd: leaf(mesh, sd[0], sd[1], SH.param_spec(mesh, path, sd[0])),
        M.param_shapes(cfg, PARAM_DTYPE),
    )


def opt_state_specs(cfg: ModelConfig, mesh) -> dict:
    shapes = M.param_shapes(cfg, PARAM_DTYPE)

    def moment(path, sd):
        return leaf(mesh, sd[0], torch.float32, SH.opt_state_spec(mesh, path, sd[0]))

    return {
        "m": SH.map_with_path(moment, shapes),
        "v": SH.map_with_path(moment, shapes),
        "step": leaf(mesh, (), torch.int32, ()),
    }


def _batch_axis(mesh, b: int):
    return SH.batch_spec(mesh, b)[0]


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, *, seq_len=None) -> dict:
    b = shape.global_batch
    s = seq_len if seq_len is not None else shape.seq_len
    bax = _batch_axis(mesh, b)
    out = {
        "tokens": leaf(mesh, (b, s), torch.int32, (bax, None)),
        "targets": leaf(mesh, (b, s), torch.int32, (bax, None)),
    }
    if cfg.family == "vlm":
        out["patch_embeds"] = leaf(mesh, (b, cfg.num_patches, cfg.d_model), PARAM_DTYPE, (bax, None, None))
    if cfg.family == "encdec":
        out["frames"] = leaf(mesh, (b, cfg.encoder_seq, cfg.d_model), PARAM_DTYPE, (bax, None, None))
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, *, seq_shard: bool) -> dict:
    shapes = M.cache_shapes(cfg, shape.global_batch, shape.seq_len, CACHE_DTYPE)
    return {key: leaf(mesh, sd[0], sd[1], SH.cache_spec(mesh, key, sd[0], seq_shard=seq_shard))
            for key, sd in shapes.items()}


def token_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> LeafSpec:
    b = shape.global_batch
    return leaf(mesh, (b, 1), torch.int32, (_batch_axis(mesh, b), None))


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """Every input of the cell's step function."""
    if shape.kind == "train":
        return {
            "params": param_specs(cfg, mesh),
            "opt_state": opt_state_specs(cfg, mesh),
            "batch": batch_specs(cfg, shape, mesh),
        }
    if shape.kind == "prefill":
        return {
            "params": param_specs(cfg, mesh),
            "batch": batch_specs(cfg, shape, mesh),
            "cache": cache_specs(cfg, shape, mesh, seq_shard=True),
        }
    if shape.kind == "decode":
        return {
            "params": param_specs(cfg, mesh),
            "token": token_specs(cfg, shape, mesh),
            "cache": cache_specs(cfg, shape, mesh, seq_shard=True),
        }
    raise ValueError(shape.kind)
