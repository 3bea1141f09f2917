"""Hand-written Hopper kernels of the port and the ops around them.

CUDA C++ in ``csrc/``, built by ``_build`` and bound with ``ctypes``:
``segment_rf`` (per-row distinct-id counting, the RF measure), ``edge_spmv``
(windowed gather-reduce), ``flash_attention``, ``decode_attention``,
``full_reorder`` (the GEO greedy) and ``rescale_migrate`` (a rescale's
migration in one pass).
"""
