"""The rescale's migration as one CUDA kernel: a rank's new row block, written in one pass.

Replaces no ``pl.pallas_call``. It is the port's counterpart of the JAX
package's one jitted slice-copy program, ``repro/elastic/rescale_exec.py``
lines 470-484 (``migrate``: zeros, one slice copy a plan segment, the k_new
mask, compiled by ``jax.jit`` / ``donate_jit``), as the hand-written CUDA
kernel ``csrc/rescale_migrate.cu``, built for ``sm_90a`` and called through
``ctypes``.

A ``MigrateTable`` (``migrate_table``) cuts the rank's block of new rows
into pieces that cover every slot once: the local copy segments of the
plan, the receive ranges that the exchange between ranks fills, and zero
pieces (the tail past each row's size, the whole width of a padded row).
``migrate`` writes, for each new row r: the old edges of each copy piece,
zeros in each zero piece, and the mask (1 below the row's size, 0 past it).
It writes no edge of a receive range.

The kernel is bound by bytes: it reads 8 bytes an edge it copies and writes
12 bytes a slot (8 of edges, 4 of mask), so ``(8 · copied + 12 · slots) /
3.35e12`` s is the least time an H100 could take: 0.094 ms at the RMAT-20
plans 16→17, 8→12 and 12→8 on one rank. One CTA a tile of ``TILE_SLOTS``
slots, found through a table of one int32 a tile (see the source's note).

Dispatch: old edges on the CPU go to the plain version ``migrate_torch``
(a fill of each zero piece, one slice copy a copy piece, the mask from the
row sizes); CUDA tensors launch the kernel or raise. ``launches`` counts
kernel launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build

__all__ = ["RECV", "TILE_SLOTS", "ZERO", "MigrateTable", "launches", "migrate", "migrate_table", "migrate_torch"]

launches = 0  # kernel launches by migrate since import (or a reset)
TILE_SLOTS = 4096  # slots a CTA writes: about 3,800 CTAs at RMAT-20's 15.7M slots
ZERO, RECV = -1, -2  # piece kinds in the source-row column (csrc/rescale_migrate.cu kZero, kRecv)
_fn = None  # rescale_migrate with its ctypes signature set once


@dataclasses.dataclass(frozen=True)
class MigrateTable:
    """The pieces of one rank's migration, on the host and on the device.

    ``pieces`` holds a row a piece, ``(row, a_new, b_new, src, a_old,
    first_tile)`` int64, in row and ``a_new`` order: ``src`` is the old row
    of a copy piece, ``ZERO`` for a zero piece and ``RECV`` for a receive
    range. ``tile_piece`` names each tile's piece. The device copies are
    uploaded once, where the table is built."""

    pieces: np.ndarray  # (P, 6) int64
    tile_piece: np.ndarray  # (T,) int32
    sizes: np.ndarray  # (rows,) int64: the edges each new row holds
    width: int  # E_max at k_new
    tile: int  # slots a tile, a CTA's share
    old_rows: int  # the old rows the copies read: the old block has at least these
    old_width: int  # ... and at least this width
    device_pieces: torch.Tensor
    device_tile_piece: torch.Tensor

    @property
    def rows(self) -> int:
        return int(self.sizes.shape[0])

    @property
    def tiles(self) -> int:
        return int(self.tile_piece.shape[0])


def migrate_table(local, recvs, sizes, width: int, device=None, tile: int = TILE_SLOTS) -> MigrateTable:
    """Cut a rank's new block into pieces: ``local`` are the copy segments
    ``(row_old, a_old, b_old, row_new, a_new, b_new)``, ``recvs`` the receive
    ranges ``(row_new, a_new, b_new)`` and ``sizes`` the edges each new row
    holds. The segments and ranges of a row must tile ``[0, size)`` exactly;
    each row's zero tail ``[size, width)`` becomes a piece of its own. Raises
    ``ValueError`` on a gap, an overlap or a copy of unequal lengths."""
    sizes = np.asarray(sizes, dtype=np.int64).reshape(-1)
    width = int(width)
    if tile <= 0 or (sizes < 0).any() or (sizes > width).any():
        raise ValueError(f"migrate_table: tile {tile}, row sizes {sizes.tolist()} and width {width} do not fit")
    by_row = [[] for _ in range(sizes.shape[0])]
    for r_old, a_old, b_old, r, a, b in local:
        if b_old - a_old != b - a:
            raise ValueError(f"migrate_table: a copy of {b_old - a_old} edges into {b - a} slots")
        by_row[r].append((a, b, r_old, a_old))
    for r, a, b in recvs:
        by_row[r].append((a, b, RECV, 0))
    pieces = []
    for r, segs in enumerate(by_row):
        at = 0
        for a, b, src, a_old in sorted(segs):
            if a != at or b <= a:
                raise ValueError(f"migrate_table: row {r}'s segments {sorted(segs)} do not tile [0, {sizes[r]})")
            pieces.append((r, a, b, src, a_old))
            at = b
        if at != sizes[r]:
            raise ValueError(f"migrate_table: row {r}'s segments end at {at}, its size is {sizes[r]}")
        if at < width:
            pieces.append((r, at, width, ZERO, 0))
    arr = np.zeros((len(pieces), 6), dtype=np.int64)
    if pieces:
        arr[:, :5] = pieces
    ntiles = -(-(arr[:, 2] - arr[:, 1]) // tile)
    arr[:, 5] = np.concatenate([[0], np.cumsum(ntiles)[:-1]]) if pieces else 0
    if ntiles.sum() >= 2**31:
        raise ValueError(f"migrate_table: {int(ntiles.sum())} tiles, the grid takes fewer than 2**31")
    tile_piece = np.repeat(np.arange(len(pieces), dtype=np.int32), ntiles)
    copies = arr[arr[:, 3] >= 0]
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cuda":
        _prepare(dev)
    return MigrateTable(
        pieces=arr, tile_piece=tile_piece, sizes=sizes, width=width, tile=int(tile),
        old_rows=int(copies[:, 3].max()) + 1 if len(copies) else 0,
        old_width=int((copies[:, 4] + copies[:, 2] - copies[:, 1]).max()) if len(copies) else 0,
        device_pieces=torch.from_numpy(arr).to(dev), device_tile_piece=torch.from_numpy(tile_piece).to(dev),
    )


def _outputs(old_edges: torch.Tensor, table: MigrateTable, out) -> tuple:
    shapes = ((table.rows, table.width, 2), (table.rows, table.width))
    if out is None:
        return (torch.empty(shapes[0], dtype=torch.int32, device=old_edges.device),
                torch.empty(shapes[1], dtype=torch.float32, device=old_edges.device))
    for t, shape, dtype in zip(out, shapes, (torch.int32, torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != old_edges.device or not t.is_contiguous():
            raise ValueError(f"migrate: out must be contiguous {dtype} of shape {shape} on {old_edges.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return tuple(out)


def migrate_torch(old_edges: torch.Tensor, table: MigrateTable, out=None) -> tuple:
    """Plain PyTorch version: a fill of each zero piece, one slice copy a copy
    piece, the mask from the row sizes; the receive ranges' edges untouched."""
    new_edges, new_mask = _outputs(old_edges, table, out)
    for row, a, b, src, a_old, _ in table.pieces.tolist():
        if src >= 0:
            new_edges[row, a:b] = old_edges[src, a_old:a_old + b - a]
        elif src == ZERO:
            new_edges[row, a:b] = 0
    sizes = torch.from_numpy(table.sizes).to(old_edges.device)
    new_mask.copy_(torch.arange(table.width, device=old_edges.device)[None, :] < sizes[:, None])
    return new_edges, new_mask


def _prepare(dev: torch.device) -> None:
    """Load the kernel on ``dev`` where a table is built for it: the
    library's CUDA runtime and the kernel's module start at their first call,
    which would otherwise land in the first migration (tens of ms in a fresh
    process). Launches nothing."""
    fn = _build.load("rescale_migrate").rescale_migrate_prepare
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        _build.check_launch("rescale_migrate", fn())


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rescale_migrate").rescale_migrate
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def migrate(old_edges: torch.Tensor, table: MigrateTable, out=None) -> tuple:
    """old_edges: the rank's ``(m_old, E_old, 2)`` int32 block → its new
    ``(rows, width, 2)`` int32 edges and ``(rows, width)`` f32 mask, written
    into ``out`` where it is given. Receive ranges' edges are not written."""
    global launches
    if old_edges.dtype != torch.int32 or old_edges.dim() != 3 or old_edges.shape[2] != 2:
        raise TypeError(f"migrate takes a (rows, width, 2) int32 tensor, got {old_edges.dim()}-D {old_edges.dtype} "
                        f"of shape {tuple(old_edges.shape)}")
    if not old_edges.is_contiguous():
        raise ValueError("migrate takes a contiguous tensor")
    if old_edges.shape[0] < table.old_rows or old_edges.shape[1] < table.old_width:
        raise ValueError(f"migrate: the table copies from {table.old_rows} rows of {table.old_width} edges, the old "
                         f"block is {tuple(old_edges.shape[:2])}")
    dev = old_edges.device
    if dev.type == "cpu":
        return migrate_torch(old_edges, table, out)
    if dev.type != "cuda":
        raise ValueError(f"migrate runs on CUDA or CPU tensors, got {dev}")
    if table.device_pieces.device != dev:
        raise ValueError(f"migrate: the table is on {table.device_pieces.device}, the edges on {dev}")
    new_edges, new_mask = _outputs(old_edges, table, out)
    if table.tiles == 0:
        return new_edges, new_mask  # no slot: nothing to launch
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(old_edges.data_ptr(), old_edges.shape[1], new_edges.data_ptr(), new_mask.data_ptr(), table.width,
                 table.device_pieces.data_ptr(), table.device_tile_piece.data_ptr(), table.tiles,
                 table.tile, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("rescale_migrate", err)
    launches += 1
    return new_edges, new_mask
