"""Distribution context of the LM harness, on one card.

The reference's ``repro.models.dist`` carries a ``Distribution`` over a JAX
mesh: GSPMD sharding hints on the activations, and sequence-parallel decode
(``sp_decode_attention``, ``sp_cache_update``: each device attends over its
own slice of the KV cache, and the partials are merged by log-sum-exp). On one
card there is no mesh: no hint has anything to constrain, the layers call
none, and the data-parallel size is 1. Sequence-parallel decode over
``GraphGroup`` ranks is a later slice of the port (ROADMAP A7); until then
``use_distribution`` takes only ``None``.
"""
from __future__ import annotations

import contextlib


def current():
    """The live distribution: always ``None`` on one card."""
    return None


@contextlib.contextmanager
def use_distribution(dist):
    if dist is not None:
        raise NotImplementedError(
            "sequence-parallel decode over ranks (the reference's Distribution, sp_decode_attention and "
            "sp_cache_update) is not ported yet: ROADMAP A7, SP decode over GraphGroup ranks"
        )
    yield


def dp_size() -> int:
    """Product of the batch-sharding axes: 1 without a distribution."""
    return 1
