"""Plain torch model of B4 (``csrc/transpose.cu``), the tiled transpose
(N, A, B) -> (N, B, A) of 2- or 4-byte elements.

The wrapper's plain version (``transpose2d_plain``) is one torch call; this
module instead moves every element the way the kernel does, so that the
tests can hold the kernel's index map against the JAX package and count
what it asks of shared memory and of the L2 on the CPU. Nothing on the
codec's path calls it.

The vector path (A and B multiples of P = 16 / element size, both pointers
16-byte aligned; :func:`vector_path`): a linear tile index walks (N, A
tiles, B tiles), B tiles innermost. A tile is ``TA`` x ``TB`` =
``PIECES`` P x 32 P elements, one block of ``BLOCK`` threads. Thread
(warp, lane) holds the P x P block at rows ``pa`` P .. + P and columns
``qb`` P .. + P of the tile (:func:`thread_pieces`), loaded as P 16-byte
pieces, one a row, masked per piece at A and B. :func:`turn` turns the
block in registers (``__byte_perm`` for int16): piece k then holds column
``qb`` P + k. It goes to piece ``pa`` of row ``qb`` P + k of a shared tile
in output order (``TB`` rows of ``PIECES`` pieces), permuted by
:func:`swizzle`. Thread i then reads piece ``i % PIECES`` of rows ``i //
PIECES + m BLOCK / PIECES`` and stores each to output row ``c0 + row``,
columns ``r0 + piece P``, masked per piece.

The element-wise path (every other shape or alignment): 32 x 32 tiles, 32 x
8 threads, one element a thread, staged as 32-bit words in a 32 x 33 tile.

What ties this model to the kernel: ``tests/test_torch_transpose.py`` reads
the tile constants out of ``csrc/transpose.cu``; on the card,
``tests/test_torch_cuda.py`` holds :func:`geometry` and :func:`vector_path`
to the kernel's own ``dr_transpose_geometry`` and
``dr_transpose_vector_path`` (which ``dr_transpose2d`` itself calls), and
this model's output to the kernel's. The swizzle, the thread-to-piece map
and the turn are restated here: the card checks them only through the
kernel's output.
"""

from __future__ import annotations

import torch

BLOCK = 256  # threads of a block
WARPS_A = 2  # warps of a block along A
LANES_A = 4  # threads of a warp along A
LANES_B = 8  # along B
WARPS_B = BLOCK // 32 // WARPS_A
PIECES = WARPS_A * LANES_A  # 16-byte pieces of a shared tile row
EDGE_TILE = 32  # element-wise path: tile edge
EDGE_ROWS = 8  # its rows of threads (32 x 8)
BANKS = 32  # 4-byte shared-memory banks
SECTOR = 32  # bytes: the unit of a request to the L2
LINE = 128  # bytes: a cache line


def piece(esize: int) -> int:
    """Elements of a 16-byte piece."""
    return 16 // esize


def tile_shape(esize: int) -> tuple[int, int]:
    """(TA, TB): a vector tile's rows (along A) and columns (along B)."""
    p = piece(esize)
    return PIECES * p, WARPS_B * LANES_B * p


def geometry(esize: int) -> tuple[int, ...]:
    """The tiles in the order ``dr_transpose_geometry`` reports the
    kernel's: threads of a block, warps along A, threads of a warp along A,
    along B, pieces of a shared tile row, the vector tile's rows and
    columns, the element-wise tile's edge and its rows of threads."""
    return (BLOCK, WARPS_A, LANES_A, LANES_B, PIECES, *tile_shape(esize),
            EDGE_TILE, EDGE_ROWS)


def vector_path(a: int, b: int, esize: int, x_offset: int = 0) -> bool:
    """The choice of ``dr_transpose2d``: 16-byte accesses where both row
    pitches and both pointers allow them (``x_offset``: the input's byte
    offset from a 16-byte boundary; the wrapper's output is aligned)."""
    p = piece(esize)
    return a % p == 0 and b % p == 0 and x_offset % 16 == 0


def swizzle(row, piece_index, esize: int):
    """Where piece ``piece_index`` of shared tile row ``row`` sits."""
    return piece_index ^ ((row // piece(esize)) & 7)


def thread_pieces():
    """(pa, qb, j) of each thread: its block's piece index along A and
    along B, and the piece index it reads back and stores."""
    t = torch.arange(BLOCK)
    lane, warp = t & 31, t >> 5
    pa = (warp % WARPS_A) * LANES_A + (lane >> 3)
    qb = (warp // WARPS_A) * LANES_B + (lane & 7)
    return pa, qb, t % PIECES


def tile_origins(n: int, a: int, b: int, ta: int, tb: int):
    """(matrix, r0, c0) of every tile in the order of the linear index."""
    tiles_b, tiles_a = -(-b // tb), -(-a // ta)
    t = torch.arange(n * tiles_a * tiles_b)
    per = tiles_a * tiles_b
    rem = t % per
    return t // per, (rem // tiles_b) * ta, (rem % tiles_b) * tb


def byte_perm(x, y, selector: int):
    """``__byte_perm(x, y, selector)`` on int64 tensors of 32-bit
    patterns: byte i of the result is byte ``selector >> 4 i & 7`` of the
    8 bytes y:x."""
    out = torch.zeros_like(x)
    for i in range(4):
        s = (selector >> (4 * i)) & 7
        src = x if s < 4 else y
        out |= ((src >> (8 * (s & 3))) & 0xFF) << (8 * i)
    return out


def pack(elems, esize: int):
    """(..., P) elements (int64) -> (..., 4) 32-bit words, little-endian."""
    if esize == 4:
        return elems & 0xFFFFFFFF
    e = elems & 0xFFFF
    return e[..., 0::2] | (e[..., 1::2] << 16)


def unpack(words, esize: int):
    """(..., 4) 32-bit words -> (..., P) signed elements (int64)."""
    if esize == 4:
        return torch.where(words >= 2**31, words - 2**32, words)
    halves = torch.stack([words & 0xFFFF, words >> 16], dim=-1).flatten(-2)
    return torch.where(halves >= 2**15, halves - 2**16, halves)


def turn(words, esize: int):
    """The kernel's register turn of (..., P, 4) words: P pieces of P rows
    in, P pieces of P columns out."""
    p = piece(esize)
    out = torch.empty_like(words)
    for c in range(p):
        for w in range(4):
            if p == 8:  # rows 2w and 2w + 1 of column c
                out[..., c, w] = byte_perm(words[..., 2 * w, c // 2],
                                           words[..., 2 * w + 1, c // 2],
                                           0x7632 if c & 1 else 0x5410)
            else:
                out[..., c, w] = words[..., w, c]
    return out


def _vector(x, esize: int):
    n, a, b = x.shape
    p = piece(esize)
    ta, tb = tile_shape(esize)
    mat, r0, c0 = tile_origins(n, a, b, ta, tb)
    pa, qb, j = thread_pieces()
    k = torch.arange(p)
    # loads: (tile, thread, k rows, P columns), a piece masked as a whole
    rows = r0.view(-1, 1, 1) + pa.view(1, -1, 1) * p + k.view(1, 1, -1)
    col = c0.view(-1, 1) + qb.view(1, -1) * p
    ok = (rows < a) & (col < b).unsqueeze(-1)
    cols = col.view(*col.shape, 1, 1) + k.view(1, 1, 1, -1)
    flat = ((mat.view(-1, 1, 1) * a + rows.clamp(max=a - 1)) * b
            ).unsqueeze(-1) + cols.clamp(max=b - 1)
    vals = x.reshape(-1)[flat] * ok.unsqueeze(-1)
    turned = turn(pack(vals, esize), esize)
    # shared tile, output order; every (row, piece) written exactly once
    o = qb.view(-1, 1) * p + k.view(1, -1)
    slot = o * PIECES + swizzle(o, pa.view(-1, 1), esize)
    assert torch.equal(slot.flatten().sort().values,
                       torch.arange(tb * PIECES))
    smem = torch.empty((mat.numel(), tb * PIECES, 4), dtype=torch.int64)
    smem[:, slot.flatten()] = turned.flatten(1, 2)
    # read back and store: (tile, thread, m)
    m = torch.arange(tb * PIECES // BLOCK)
    orow = (torch.arange(BLOCK) // PIECES).view(-1, 1) + m.view(1, -1) * (
        BLOCK // PIECES)
    read = orow * PIECES + swizzle(orow, j.view(-1, 1), esize)
    pieces = unpack(smem[:, read.flatten()], esize).view(
        mat.numel(), BLOCK, m.numel(), p)
    out_row = c0.view(-1, 1, 1) + orow.unsqueeze(0)
    out_col = r0.view(-1, 1, 1) + (j * p).view(1, -1, 1)
    keep = (out_row < b) & (out_col < a)
    base = (mat.view(-1, 1, 1) * b + out_row) * a + out_col
    dest = base.unsqueeze(-1) + torch.arange(p)
    out = torch.full((n * b * a,), -(2**40), dtype=torch.int64)
    out[dest[keep]] = pieces[keep]
    return out.view(n, b, a)


def _edge(x):
    n, a, b = x.shape
    mat, row0, col0 = tile_origins(n, a, b, EDGE_TILE, EDGE_TILE)
    tx = torch.arange(EDGE_TILE).view(1, 1, -1)
    jj = torch.arange(EDGE_TILE).view(1, -1, 1)  # every j the threads walk
    r = row0.view(-1, 1, 1) + jj
    c = col0.view(-1, 1, 1) + tx
    ok = (r < a) & (c < b)
    flat = (mat.view(-1, 1, 1) * a + r.clamp(max=a - 1)) * b + c.clamp(
        max=b - 1)
    tile = x.reshape(-1)[flat] * ok  # tile[j][tx], 32-bit words
    orow = col0.view(-1, 1, 1) + jj  # out row col0 + j, column row0 + tx
    ocol = row0.view(-1, 1, 1) + tx
    keep = (orow < b) & (ocol < a)
    dest = (mat.view(-1, 1, 1) * b + orow) * a + ocol
    out = torch.full((n * b * a,), -(2**40), dtype=torch.int64)
    out[dest[keep]] = tile.transpose(1, 2)[keep]  # tile[tx][j]
    return out.view(n, b, a)


def transpose_model(x: torch.Tensor, x_offset: int = 0):
    """The kernel's output for a contiguous 2-D or 3-D ``x`` whose data
    pointer sits ``x_offset`` bytes past a 16-byte boundary (the output
    is aligned). Returns (out, path): the same dtype as x, and "vector" or
    "edge"."""
    esize = x.element_size()
    a, b = x.shape[-2:]
    x3 = x.reshape(-1, a, b)
    if x.dtype == torch.uint32:
        x3 = x3.view(torch.int32)
    x3 = x3.to(torch.int64)
    vec = vector_path(a, b, esize, x_offset)
    out = _vector(x3, esize) if vec else _edge(x3)
    assert out.numel() == 0 or int(out.min()) > -(2**40), \
        "an element was never stored"
    out = out.to(torch.int32 if esize == 4 else torch.int16)
    if x.dtype == torch.uint32:
        out = out.view(torch.uint32)
    return out.view(x.shape[:-2] + (b, a)), "vector" if vec else "edge"


def shared_phases(esize: int):
    """Banks of every shared-memory access of the vector path, by warp
    instruction: (instructions, 4 quarter warps, 8 threads x 4 banks).
    A 16-byte access is served a quarter warp at a time; a quarter warp
    that meets 32 distinct banks takes one wavefront."""
    p = piece(esize)
    pa, qb, j = thread_pieces()
    k = torch.arange(p).view(1, -1)
    o = qb.view(-1, 1) * p + k  # writes: (thread, k)
    writes = o * PIECES + swizzle(o, pa.view(-1, 1), esize)
    _, tb = tile_shape(esize)
    m = torch.arange(tb * PIECES // BLOCK).view(1, -1)
    orow = (torch.arange(BLOCK) // PIECES).view(-1, 1) + m * (BLOCK // PIECES)
    reads = orow * PIECES + swizzle(orow, j.view(-1, 1), esize)
    slots = torch.cat([writes, reads], dim=1)  # (thread, instruction)
    # (warp, instruction, quarter, 8 threads): 16-byte slot -> 4 banks
    by_warp = slots.view(BLOCK // 32, 4, 8, -1).permute(0, 3, 1, 2)
    banks = (by_warp.unsqueeze(-1) * 4 + torch.arange(4)) % BANKS
    return banks.reshape(-1, 4, 32)


def edge_banks():
    """Banks of the element-wise path's shared accesses, by warp
    instruction: (instructions, 32 threads), 4-byte words."""
    tx = torch.arange(EDGE_TILE)
    pitch = EDGE_TILE + 1
    rows = torch.arange(EDGE_TILE).view(-1, 1)  # a warp's j
    writes = (rows * pitch + tx) % BANKS  # tile[j][tx]
    reads = (tx * pitch + rows) % BANKS  # tile[tx][j]
    return torch.cat([writes, reads])


def global_requests(n: int, a: int, b: int, esize: int):
    """Sectors and lines of each warp instruction of the vector path, for
    x and out starting on a 128-byte boundary: a dict of loads and stores,
    each (instructions, sectors touched, sectors not wholly written or
    read, lines touched, lines not whole)."""
    p = piece(esize)
    ta, tb = tile_shape(esize)
    mat, r0, c0 = tile_origins(n, a, b, ta, tb)
    pa, qb, j = thread_pieces()
    k = torch.arange(p)
    warp = torch.arange(BLOCK) // 32
    # loads: byte address of each piece, by (tile, thread, k)
    rows = r0.view(-1, 1, 1) + pa.view(1, -1, 1) * p + k.view(1, 1, -1)
    col = (c0.view(-1, 1) + qb.view(1, -1) * p).unsqueeze(-1)
    ok = (rows < a) & (col < b)
    load = ((mat.view(-1, 1, 1) * a + rows) * b + col) * esize
    m = torch.arange(tb * PIECES // BLOCK)
    orow = c0.view(-1, 1, 1) + ((torch.arange(BLOCK) // PIECES).view(1, -1, 1)
                                + m.view(1, 1, -1) * (BLOCK // PIECES))
    ocol = (r0.view(-1, 1) + (j * p).view(1, -1)).unsqueeze(-1)
    sok = (orow < b) & (ocol < a)
    store = ((mat.view(-1, 1, 1) * b + orow) * a + ocol) * esize
    return {"loads": _requests(load, ok, warp),
            "stores": _requests(store, sok, warp)}


def _requests(addr, ok, warp):
    """Count over (tile, thread, instruction) 16-byte accesses grouped by
    (tile, warp, instruction)."""
    tiles, _, ninstr = addr.shape
    instr = (torch.arange(tiles).view(-1, 1, 1) * (BLOCK // 32)
             + warp.view(1, -1, 1)) * ninstr + torch.arange(ninstr)
    instr, addr = instr.expand_as(addr)[ok], addr[ok]
    out = {"instructions": int(torch.unique(instr).numel())}
    for unit, name in ((SECTOR, "sectors"), (LINE, "lines")):
        key = instr * (2**40) + addr // unit
        ids, counts = torch.unique(key, return_counts=True)
        out[name] = int(ids.numel())
        out[f"partial_{name}"] = int((counts * 16 < unit).sum())
    return out
