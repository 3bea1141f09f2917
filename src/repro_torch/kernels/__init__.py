"""Hand-written Hopper kernels of the port and the ops around them.

CUDA C++ in ``csrc/``, built by ``_build`` and bound with ``ctypes``:
``segment_rf`` (per-row distinct-id counting, the RF measure), ``edge_spmv``
(windowed gather-reduce), ``flash_attention``, ``decode_attention``,
``full_reorder`` (the GEO greedy), ``rescale_migrate`` (a rescale's
migration in one pass) and ``min_sweep`` (one SSSP or WCC sweep in one
pass).
"""
