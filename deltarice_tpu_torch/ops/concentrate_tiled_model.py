"""Plain torch model of the decomposition of B7 and B8
(``csrc/concentrate_tiled.cu``), concentration in the tiled staging layout.

The kernels' wrappers take the butterfly plain versions
(``concentrate_tiled_plain``, ``concentrate_tiled_vd_plain``) on a CPU
tensor; this module instead walks the planes as the kernels do, with their
offsets and their order of stores, so that the tests can hold that walk
against the JAX package, and ``chip_smoke.py`` can count the stores an
input costs on the card. Nothing on the codec's path calls it.

Per block, a (blocks, R * sb, lanes) plane is an (R, C) array with C = sb *
lanes columns, column c being segment c. A memset zeroes the intermediate
``work`` (blocks, C, :func:`work_stride`). Pass 1 (``walk_kernel``): a warp
owns ``WARP_COLS`` columns and a span of whole ``STAGE``s of slots; it
stages ``STAGE`` slots of its columns at a time and, column by column, lets
its 32 lanes take ``RUN`` consecutive slots: one store instruction, which
lands each kept slot (destination t - disp inside [0, slots out)) at
``(block * C + column) * stride + destination``. Which warp walks a stage
changes no offset, so the model walks every stage. Pass 2
(``untile_kernel``): ``TILE`` x ``TILE`` tiles of ``work`` (columns x
slots) go through a shared-memory tile whose 16-byte pieces each row
permutes (:func:`swizzle`) into the (blocks, slots out, C) output.
"""

from __future__ import annotations

import torch

from .concentrate_cuda import DEAD
from .concentrate_tiled_cuda import TILE, out_rows, work_stride
from .pack_ref import as_i32

WARP_COLS = 32  # pass 1: the columns a warp owns
STAGE = 128  # pass 1: the slots a warp stages at a time
RUN = 32  # pass 1: the slots of one store instruction, a lane each
SECTOR = 32  # bytes: the unit of a store request to the L2


def _padded(x, rows: int, cols: int):
    """(blocks, r, c) -> (blocks, rows, cols), zero (False) past r and c."""
    out = torch.zeros((x.shape[0], rows, cols), dtype=x.dtype,
                      device=x.device)
    out[:, : x.shape[1], : x.shape[2]] = x
    return out


def pass1(dest, keep, val, slots_out: int):
    """Pass 1 over (blocks, R, C) destinations, kept slots and values into
    the zeroed intermediate, flat. Returns it and the counts: the kept
    slots, the store instructions (a (stage, column, run) with a kept
    slot) and the 32-byte sectors they touch, each instruction's counted
    apart."""
    blocks, r, cols = dest.shape
    stride = work_stride(slots_out)
    ns, ng = -(-r // STAGE), -(-cols // WARP_COLS)

    def store_order(x):
        # (block, stage, run, lane, group, column) -> (block, group, stage,
        # column, run, lane): a warp's stores, lanes innermost; nothing is
        # kept past the slot axis (the walk stops there) or the columns
        x = _padded(x, ns * STAGE, ng * WARP_COLS)
        return (x.reshape(blocks, ns, STAGE // RUN, RUN, ng, WARP_COLS)
                .permute(0, 4, 1, 5, 2, 3))

    dest, keep, val = map(store_order, (dest, keep, val))
    dev = dest.device
    b = torch.arange(blocks, device=dev).view(-1, 1, 1, 1, 1, 1)
    col = (torch.arange(ng, device=dev).view(1, -1, 1, 1, 1, 1) * WARP_COLS
           + torch.arange(WARP_COLS, device=dev).view(1, 1, 1, -1, 1, 1))
    off = ((b * cols + col) * stride + dest)[keep]
    work = torch.zeros(blocks * cols * stride, dtype=val.dtype, device=dev)
    work[off] = val[keep]
    instr = torch.arange(keep[..., 0].numel(), device=dev).view(
        keep.shape[:-1] + (1,)).expand(keep.shape)[keep]
    esize = val.element_size()
    row_sectors = stride * esize // SECTOR  # rows start on a sector
    counts = {
        "kept": int(off.numel()),
        "store_instructions": int(torch.unique(instr).numel()),
        "store_sectors": int(torch.unique(
            instr * row_sectors + dest[keep] * esize // SECTOR).numel()),
    }
    return work, counts


def swizzle(esize: int) -> torch.Tensor:
    """(TILE, TILE): where pass 2's shared-memory tile keeps element
    ``col`` of row ``row``, for elements of ``esize`` bytes: 16-byte piece
    ``col // p`` of the row moved to piece ``col // p ^ (row // p)``
    (modulo the row's pieces), p the elements of a piece."""
    p = 16 // esize
    row = torch.arange(TILE)[:, None]
    col = torch.arange(TILE)[None, :]
    return ((col // p) ^ ((row // p) & (TILE // p - 1))) * p + (col & (p - 1))


def pass2(work, blocks: int, cols: int, slots_out: int):
    """Pass 2: the flat intermediate back into (blocks, slots_out, C),
    tile by tile through the swizzled shared-memory tile."""
    stride = work_stride(slots_out)
    nct, nst = -(-cols // TILE), -(-slots_out // TILE)
    # a tile's columns past C read as 0; its slots stay inside the stride
    w = _padded(work.view(blocks, cols, stride)[:, :, : nst * TILE],
                nct * TILE, nst * TILE)
    # (block, column tile, column, slot tile, slot) -> (block, slot tile,
    # column tile, slot, column)
    tiles = w.reshape(blocks, nct, TILE, nst, TILE).permute(0, 3, 1, 4, 2)
    at = swizzle(work.element_size()).to(work.device).expand(tiles.shape)
    smem = torch.zeros(tiles.shape, dtype=work.dtype, device=work.device)
    smem.scatter_(-1, at, tiles)
    back = smem.gather(-1, at)
    return (back.permute(0, 1, 3, 2, 4).reshape(blocks, nst * TILE,
                                                 nct * TILE)
            [:, :slots_out, :cols])


def walk(dest, keep, val, slots_out: int):
    """Both passes over (blocks, R, C) destinations, kept slots and values.
    Returns the (blocks, slots_out, C) output and :func:`pass1`'s counts."""
    blocks, _r, cols = dest.shape
    work, counts = pass1(dest, keep, val, slots_out)
    return pass2(work, blocks, cols, slots_out), counts


def _block_view(plane, sb):
    """(blocks, R * sb, lanes) -> (blocks, R, C)."""
    blocks, rows, lanes = plane.shape
    return plane.reshape(blocks, rows // sb, sb * lanes)


def _tiled(out, sb, lanes):
    blocks, slots, _cols = out.shape
    return out.reshape(blocks, slots * sb, lanes)


def concentrate_tiled_model(planes, n_out: int, sb: int, emit: str = "int16",
                            bias: bool = False):
    """B7 as the kernels walk it. Same arguments and output as
    ``concentrate_tiled``; returns (output, :func:`walk`'s counts)."""
    lead = planes[0]
    follow = planes[1] if len(planes) == 2 else None
    blocks, rows_in, lanes = lead.shape
    slots_out = out_rows(rows_in, n_out, sb) // sb
    p = _block_view(lead, sb).to(torch.int64)
    q = p & 0xFFFFFFFF
    if bias:
        q = q ^ (1 << 31)
    t = torch.arange(rows_in // sb, device=lead.device)[None, :, None]
    dest = t - (q >> 16)
    # dead (or, biased, a live 0 at displacement 0: the memset's 0)
    keep = (p != DEAD) & (dest >= 0) & (dest < slots_out)
    half = q & 0xFFFF
    if emit == "int16":
        val = ((half ^ 0x8000) - 0x8000).to(torch.int16)
    elif follow is None:
        val = half.to(torch.int32)
    else:
        lo = _block_view(follow, sb).to(torch.int64) & 0xFFFF
        val = as_i32((half << 16) | lo)
    out, counts = walk(dest, keep, val, slots_out)
    return _tiled(out, sb, lanes), counts


def concentrate_tiled_vd_model(values: torch.Tensor, disp: torch.Tensor,
                               n_out: int, sb: int):
    """B8 as the kernels walk it. Same arguments and output as
    ``concentrate_tiled_vd``; returns (output, :func:`walk`'s counts)."""
    blocks, rows_in, lanes = values.shape
    slots_out = out_rows(rows_in, n_out, sb) // sb
    d = _block_view(disp, sb).to(torch.int64)
    t = torch.arange(rows_in // sb, device=values.device)[None, :, None]
    dest = t - d
    keep = (d >= 0) & (dest >= 0) & (dest < slots_out)
    out, counts = walk(dest, keep, _block_view(values, sb), slots_out)
    return _tiled(out, sb, lanes), counts
