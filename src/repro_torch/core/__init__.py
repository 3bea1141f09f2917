"""Core of the paper: GEO ordering + CEP chunk partitioning + metrics/theory."""
from . import baselines, cep, graph, metrics, ordering, theory  # noqa: F401
from .cep import ScalePlan, chunk_bounds, chunk_size, chunk_start, id2p, scale_plan  # noqa: F401
from .graph import Graph  # noqa: F401
from .metrics import replication_factor, replication_factor_ordered  # noqa: F401
from .ordering import geo_order, geo_order_baseline  # noqa: F401
