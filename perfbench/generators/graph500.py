"""Graph500 Kronecker graphs on the device, from the seed.

The edge draw is the Graph500 specification's ``kronecker_generator``: each
of the ``edge_factor · 2^scale`` edges picks, for each of the ``scale``
bits, a quadrant of the initiator (A, B, C, D), and the vertex labels are
then permuted at random. The specification's shuffle of the edge order is
left out: the edges are ordered again below. As the LDBC Graphalytics
``graph500-*`` data sets, the graph is undirected with self-loops and
duplicate edges removed.

The order stands in for the one-time GEO order (``assumed`` in each
configuration): edges sorted by (lower endpoint, higher endpoint) of the
permuted labels, with the lower endpoint as ``src``. Vertex ids are the
label space ``[0, 2^scale)``; labels that no edge touches are isolated
vertices.

Everything runs on ``device`` from one ``torch.Generator`` seeded with the
configuration's ``instance_seed``, in a few large calls: a configuration is
one graph, as a data set is.
"""
from __future__ import annotations

import numpy as np
import torch


def generate(params: dict, device: torch.device):
    """``(src, dst, num_vertices, present)``: the ordered int32 endpoint
    lists on ``device`` and the host int64 ids of the vertices with an edge."""
    scale, edge_factor = int(params["scale"]), int(params["edge_factor"])
    a, b, c, d = (float(x) for x in params["initiator"])
    if abs(a + b + c + d - 1.0) > 1e-9 or not 0 < scale <= 30:
        raise ValueError(f"initiator {params['initiator']} must sum to 1 and scale {scale} lie in [1, 30]")
    n, m = 1 << scale, edge_factor << scale
    gen = torch.Generator(device=device)
    gen.manual_seed(int(params["instance_seed"]))
    ab = a + b
    c_norm, a_norm = (c / (c + d) if c + d else 0.0), (a / ab if ab else 0.0)
    ii = torch.zeros(m, dtype=torch.int32, device=device)
    jj = torch.zeros(m, dtype=torch.int32, device=device)
    for bit in range(scale):
        ii_bit = torch.rand(m, generator=gen, device=device) > ab
        jj_bit = torch.rand(m, generator=gen, device=device) > torch.where(ii_bit, c_norm, a_norm)
        ii += ii_bit.to(torch.int32) << bit
        jj += jj_bit.to(torch.int32) << bit
    perm = torch.randperm(n, generator=gen, device=device)
    u, v = perm[ii.long()], perm[jj.long()]
    del ii, jj, perm
    lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    keep = lo != hi
    key = torch.unique((lo[keep] << scale) | hi[keep])  # sorted: the (lower, higher) order
    del u, v, lo, hi, keep
    src, dst = (key >> scale).to(torch.int32), (key & (n - 1)).to(torch.int32)
    present = torch.unique(torch.cat([src, dst])).cpu().numpy().astype(np.int64)
    return src, dst, n, present
