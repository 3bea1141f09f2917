"""PyTorch + CUDA port of the ``repro`` package (GEO ordering, CEP chunk
partitioning, executed elastic rescales and the GAS graph apps) for one
NVIDIA Hopper GPU.

The module layout mirrors ``repro``: each module here has a counterpart of the
same name there. The package imports ``torch``, numpy and scipy only. Entry
points take ``device=None``, which means ``"cuda"``; the CPU is used only when
the caller passes ``device="cpu"`` (see ``compat.resolve_device``).
"""
