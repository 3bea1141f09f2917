"""Hand-written Hopper kernels of the port and the ops around them.

``segment_rf`` — per-row distinct-id counting (the RF measure), CUDA C++ in
``csrc/segment_rf.cu``, built by ``_build`` and bound with ``ctypes``.
"""
