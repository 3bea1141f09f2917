"""The rows of a pack, sorted for ``segment_rf``: one CUDA radix sort of the
int32 ids alone, over the bits that the vertex ids need.

Replaces no ``pl.pallas_call``. It is the port's counterpart of the JAX
package's ``jnp.sort`` of the masked rows (``repro/kernels/ops.py:58``), as
the hand-written CUDA kernels of ``csrc/packed_sort.cu``, built for
``sm_90a`` and called through ``ctypes``.

``packed_sort(edges, mask, num_vertices)`` takes a pack's edges ``(k, E, 2)``
int32 and mask ``(k, E)`` f32 and gives ``(k, 2E)`` int32: each row's valid
ids (the slots with ``mask > 0``) ascending, then ``PAD_ID`` to the end of the
row, element for element the plain version ``packed_sort_torch`` (``where``
and ``torch.sort``). Valid ids lie in ``[0, num_vertices)``; ``None`` takes
every id that is not negative (31 bits).

The sort is bound by bytes: ``(8 + 8·passes)`` bytes a valid key (see
``sort_bytes``), where ``passes = ⌈bits / 8⌉`` follows the ids' bits, 3 at
graph500-22 and -24: 4.97 ms on an H100 at graph500-24's 520,768,828 keys. It
is one histogram launch over every row and one onesweep launch a digit pass
(decoupled look-back over each row's tiles); the first pass reads the edges
and mask in place, and the passes ping-pong between the output and one
scratch tensor (see the source's note). The wrapper allocates the output, the
scratch and one zero-filled workspace; there is no sync and no readback.

Dispatch: tensors on the CPU go to the plain version; CUDA tensors launch the
kernels or raise. ``launches`` counts the sorts run on a card and ``passes``
their digit passes, so a run can show that its path went through the kernel
and how many passes it took.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from ..compat import PAD_ID
from . import _build

__all__ = ["digit_passes", "id_bits", "launches", "packed_sort", "packed_sort_torch", "passes", "sort_bytes"]

launches = 0  # sorts run on a card by packed_sort since import (or a reset): a histogram launch and its passes each
passes = 0  # digit passes launched by those sorts
DIGIT_BITS = 8  # csrc/packed_sort.cu kDigitBits
MAX_WIDTH = 2**30  # a row's keys (2E) must be fewer: the look-back words hold 30-bit counts
_lib = None  # (packed_sort, packed_sort_workspace_words) with their ctypes signatures set once


def id_bits(num_vertices: int | None = None) -> int:
    """Bits of the ids below ``num_vertices``: ``max(1, bit_length(num_vertices - 1))``; 31 for ``None``."""
    if num_vertices is None:
        return 31
    if (isinstance(num_vertices, bool) or not isinstance(num_vertices, numbers.Integral)
            or not 1 <= num_vertices < 2**31):
        raise ValueError(f"packed_sort: num_vertices must be an integer in [1, 2**31) or None, got {num_vertices!r}")
    return max(1, (int(num_vertices) - 1).bit_length())


def digit_passes(num_vertices: int | None = None) -> int:
    """Digit passes of a sort of ids below ``num_vertices``: ``⌈bits / 8⌉``."""
    return -(-id_bits(num_vertices) // DIGIT_BITS)


def sort_bytes(slots: int, valid: int, num_vertices: int | None = None) -> int:
    """The bytes a sort of ``slots`` key slots (``2·k·E_max``), ``valid`` of
    them valid, must move: every slot's 4 bytes of id and half of its edge's
    mask read by the histogram and again by the first pass, 4 bytes written
    to it (a key or ``PAD_ID``), and 8 a valid key in each later pass."""
    return 16 * int(slots) + 8 * (digit_passes(num_vertices) - 1) * int(valid)


def packed_sort_torch(edges: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: masked-out slots set to ``PAD_ID``, then each row sorted."""
    k, e_max, _ = edges.shape
    ids = torch.where(mask[..., None] > 0, edges, PAD_ID).reshape(k, 2 * e_max)
    return torch.sort(ids, dim=1).values


def _check(edges: torch.Tensor, mask: torch.Tensor) -> None:
    if edges.dtype != torch.int32 or edges.dim() != 3 or edges.shape[2] != 2:
        raise TypeError(f"packed_sort: edges must be a (k, E_max, 2) int32 tensor, got {tuple(edges.shape)} "
                        f"{edges.dtype}")
    if mask.dtype != torch.float32:
        raise TypeError(f"packed_sort: mask must be float32, got {mask.dtype}")
    if tuple(mask.shape) != tuple(edges.shape[:2]):
        raise ValueError(f"packed_sort takes edges (k, E_max, 2) and mask (k, E_max); got {tuple(edges.shape)}, "
                         f"{tuple(mask.shape)}")
    if not (edges.is_contiguous() and mask.is_contiguous()):
        raise ValueError("packed_sort: edges and mask must be contiguous")
    if mask.device != edges.device:
        raise ValueError(f"packed_sort: mask is on {mask.device}, edges on {edges.device}")


def packed_sort(edges: torch.Tensor, mask: torch.Tensor, num_vertices: int | None = None) -> torch.Tensor:
    """The pack's rows sorted, ``PAD_ID`` at each tail → ``(k, 2·E_max)`` int32 on the pack's device."""
    global launches, passes
    _check(edges, mask)
    bits = id_bits(num_vertices)
    dev = edges.device
    if dev.type == "cpu":
        return packed_sort_torch(edges, mask)
    if dev.type != "cuda":
        raise ValueError(f"packed_sort runs on CUDA or CPU tensors, got {dev}")
    k, e_max, _ = edges.shape
    if 2 * e_max >= MAX_WIDTH:
        raise ValueError(f"packed_sort takes rows of fewer than 2**30 keys, got {2 * e_max}")
    if edges.data_ptr() % 8:
        raise ValueError("packed_sort: on a card, edges must start on an 8-byte boundary")
    out = torch.empty((k, 2 * e_max), dtype=torch.int32, device=dev)
    if k == 0 or e_max == 0:  # no slots: nothing to sort and nothing to launch
        return out
    n_passes = digit_passes(num_vertices)
    with torch.cuda.device(dev):
        fn, words = _kernel()
        scratch = torch.empty_like(out) if n_passes > 1 else None
        workspace = torch.zeros(words(k, e_max, bits), dtype=torch.int32, device=dev)
        err = fn(edges.data_ptr(), mask.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                 workspace.data_ptr(), k, e_max, bits, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("packed_sort", err)
    launches += 1
    passes += n_passes
    return out


def _kernel():
    """``(packed_sort, packed_sort_workspace_words)`` of the built library,
    their ``argtypes`` and ``restype`` set where it is first loaded."""
    global _lib
    if _lib is None:
        lib = _build.load("packed_sort")
        fn = lib.packed_sort
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        words = lib.packed_sort_workspace_words
        words.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
        words.restype = ctypes.c_longlong
        _lib = fn, words
    return _lib
