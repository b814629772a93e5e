"""Concentration in the TPU decode kernels' tiled staging layout.

A tiled plane has shape (blocks, R * sb, lanes): row ``slot * sb + s``, lane
``l`` of block ``b`` holds slot ``slot`` of segment ``(b, s * lanes + l)``.
The JAX package's decode kernels emit their staging so and compact it there.

* B7 ``concentrate_tiled`` — CUDA kernel ``csrc/concentrate_tiled.cu``, the
  counterpart of ``concentrate_tiled``: a packed leader (with an optional
  int16 follower) or a sign-biased plane. The JAX decode takes it for nEDM
  staging (biased plane, the speculative branch) and for the split decode's
  per-sub-block staging.
* B8 ``concentrate_tiled_vd`` — the same file, the counterpart of
  ``concentrate_tiled_vd``: explicit int16 payload and int32 displacement
  planes, any displacement. The JAX decode takes it for NOPTREX staging.

The port's own decode kernels (B2, B9) store every sample at its final
index and make no staging, so the codec calls neither; :func:`decode_staging`
builds the staging the JAX decode kernel would emit, for holding both
kernels against their plain versions at the long profiles' shapes.

Each kernel lands every live slot at ``slot - disp`` in two passes
through a segment-major intermediate (``csrc/concentrate_tiled.cu``); each
plain version is the TPU kernels' butterfly with every pass a shift by
``(1 << b) * sb`` rows. ``ops/concentrate_tiled_model.py`` walks the
kernels' decomposition (stages of 128 slots x 32 columns, store runs of 32
slots, the intermediate's offsets, the 64 x 64 tiles back) in plain torch.
"""

from __future__ import annotations

import torch

from . import _kernels
from .concentrate_cuda import DEAD, _w16_pass
from .pack_ref import as_i32
from .prefilter import prefilter_encode
from .rice import codeword_lengths_values, zigzag

TBLK = 256  # the TPU kernels' slot block: outputs cover whole blocks
_EMITS = ("int16", "u32")
TILE = 64  # csrc/concentrate_tiled.cu's pass 2 moves TILE x TILE tiles


def work_stride(slots_out: int) -> int:
    """Elements per row (one column) of the kernels' intermediate: the
    output slots padded to an odd number of ``TILE``s."""
    return (-(-slots_out // TILE) | 1) * TILE


def out_rows(rows_in: int, n_out: int, sb: int) -> int:
    """Rows of the output: the slot blocks of ``TBLK`` that cover
    ``min(n_out, staged slots)`` (``concentrate_pallas.py:376-382``)."""
    nbk = -(-(rows_in // sb) // TBLK)
    n_slots = min(n_out, nbk * TBLK)
    return -(-n_slots // TBLK) * TBLK * sb


def _shift_rows(x: torch.Tensor, n: int, fill: int) -> torch.Tensor:
    """x[:, i] <- x[:, i + n] along the row axis, filled at the end."""
    out = torch.full_like(x, fill)
    if n < x.shape[1]:
        out[:, : x.shape[1] - n] = x[:, n:]
    return out


def _fit_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[1] < rows:
        x = torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[1]))
    return x[:, :rows].contiguous()


def _passes(slots: int, field_bits: int):
    return [b for b in range(field_bits) if (1 << b) < slots]


def concentrate_tiled_plain(planes, n_out: int, sb: int, emit: str = "int16",
                            bias: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`concentrate_tiled`: the max-butterfly
    of ``_tconc_low_kernel`` / ``_tconc_high_kernel`` over the whole slot
    axis, then ``_tconc_finalize`` / ``_tconc_bias_finalize``."""
    lead = planes[0]
    follow = planes[1] if len(planes) == 2 else None
    slots = lead.shape[1] // sb
    for b in _passes(slots, 16 if bias else 15):
        n = (1 << b) * sb
        sh = _shift_rows(lead, n, DEAD)
        if bias:
            lead = _w16_pass(lead, sh, b)
            continue
        smask = 1 << (16 + b)
        moved = (sh & smask) != 0
        if follow is not None:
            follow = torch.where(moved, _shift_rows(follow, n, 0), follow)
        lead = torch.maximum(torch.where((lead & smask) == 0, lead, DEAD),
                             torch.where(moved, sh - smask, DEAD))
    if bias:
        half = torch.where((lead & -65536) == DEAD, lead & 0xFFFF, 0)
        lo = None
    else:
        arrived = (lead >> 16) == 0
        half = torch.where(arrived, lead, 0)
        lo = (None if follow is None else
              torch.where(arrived, follow.to(torch.int32) & 0xFFFF, 0))
    if emit == "int16":
        out = (((half & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)
    elif lo is None:
        out = half
    else:
        out = as_i32((half.to(torch.int64) << 16) | lo.to(torch.int64))
    return _fit_rows(out, out_rows(planes[0].shape[1], n_out, sb))


def concentrate_tiled(planes, n_out: int, sb: int, emit: str = "int16",
                      bias: bool = False) -> torch.Tensor:
    """Concentrate packed or sign-biased planes in the tiled layout.

    Args:
      planes: ``(lead,)`` or ``(lead, follow)``, (blocks, R * sb, lanes).
        ``lead`` is int32: ``disp << 16 | halfword`` for live slots
        (0 <= disp < 2^15), or with ``bias`` ``((disp << 16) | halfword)
        ^ 2^31`` (disp < 2^16); INT32_MIN for dead ones either way;
        destinations ``slot - disp`` strictly increase along each
        segment's slots. ``follow`` is int16, the low halfword of a 32-bit
        payload (packed leaders only).
      n_out: output slots wanted per segment.
      sb: segments per lane row (row ``slot * sb + s``).
      emit: ``"int16"`` — the halfword, sign-extended (decode); ``"u32"``
        — 32-bit words as int32 bit patterns: ``hi << 16 | lo`` with a
        follower, the biased plane's halfword zero-extended without.
      bias: ``lead`` is the sign-biased plane.

    Returns:
      (blocks, :func:`out_rows`, lanes) in the same layout, int16 or int32;
      slots nothing reaches are zero. Whole blocks of ``TBLK`` slots come
      back, as from the JAX function; callers read the first ``n_out``.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`concentrate_tiled_plain`.
    """
    if emit not in _EMITS:
        raise ValueError(f"emit must be one of {_EMITS}, got {emit!r}")
    if len(planes) not in (1, 2) or (bias and len(planes) == 2):
        raise ValueError("planes are (lead,) or (lead, follow); a biased "
                         "plane has no follower")
    lead = planes[0]
    _kernels.require(lead, "lead", torch.int32, 3)
    follow = planes[1] if len(planes) == 2 else None
    if follow is not None:
        _kernels.require(follow, "follow", torch.int16, 3, lead.device)
        if follow.shape != lead.shape:
            raise ValueError("lead and follow planes differ in shape")
    blocks, rows_in, lanes = lead.shape
    if sb <= 0 or rows_in % sb:
        raise ValueError(f"plane rows {rows_in} are not a multiple of sb={sb}")
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    if not _kernels.route(lead):
        return concentrate_tiled_plain(planes, n_out, sb, emit, bias)
    rows = out_rows(rows_in, n_out, sb)
    dtype = torch.int16 if emit == "int16" else torch.int32
    out = torch.empty((blocks, rows, lanes), dtype=dtype, device=lead.device)
    work = torch.empty((blocks, sb * lanes, work_stride(rows // sb)),
                       dtype=dtype, device=lead.device)
    rc = _kernels.library().dr_concentrate_tiled(
        lead.data_ptr(), None if follow is None else follow.data_ptr(),
        out.data_ptr(), blocks, rows_in, lanes, rows, sb, int(bias),
        int(emit == "u32"), work.data_ptr(), _kernels.stream(),
    )
    _kernels.check(rc, "concentrate_tiled")
    _kernels.launches["concentrate_tiled"] += 1
    return out


def concentrate_tiled_vd_plain(values: torch.Tensor, disp: torch.Tensor,
                               n_out: int, sb: int) -> torch.Tensor:
    """Plain torch version of :func:`concentrate_tiled_vd`: the two-plane
    butterfly of ``_tvd_low_kernel`` over every displacement bit, keeping
    what arrived home (displacement 0)."""
    v = values
    d = disp
    slots = v.shape[1] // sb
    for b in _passes(slots, 31):
        s = 1 << b
        n = s * sb
        vs = _shift_rows(v, n, 0)
        ds = _shift_rows(d, n, -1)
        moving = (ds >= 0) & ((ds & s) != 0)
        staying = (d >= 0) & ((d & s) == 0)
        v = torch.where(moving, vs, torch.where(staying, v, 0))
        d = torch.where(moving, ds - s, torch.where(staying, d, -1))
    out = torch.where(d == 0, v, torch.zeros_like(v))
    return _fit_rows(out, out_rows(values.shape[1], n_out, sb))


def concentrate_tiled_vd(values: torch.Tensor, disp: torch.Tensor,
                         n_out: int, sb: int) -> torch.Tensor:
    """Concentrate explicit (payload, displacement) planes in the tiled
    layout.

    Args:
      values: (blocks, R * sb, lanes) int16 payloads.
      disp: the same shape, int32 ``slot - destination`` for live slots
        (>= 0, destinations strictly increasing along each segment's
        slots), negative for dead ones.
      n_out, sb: as for :func:`concentrate_tiled`.

    Returns:
      (blocks, :func:`out_rows`, lanes) int16; slots nothing reaches are
      zero. (The JAX function returns whole windows of its level, at least
      this many rows; callers read the first ``n_out`` slots.)

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`concentrate_tiled_vd_plain`.
    """
    _kernels.require(values, "values", torch.int16, 3)
    _kernels.require(disp, "disp", torch.int32, 3, values.device)
    if disp.shape != values.shape:
        raise ValueError("values and disp planes differ in shape")
    blocks, rows_in, lanes = values.shape
    if sb <= 0 or rows_in % sb:
        raise ValueError(f"plane rows {rows_in} are not a multiple of sb={sb}")
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    if not _kernels.route(values):
        return concentrate_tiled_vd_plain(values, disp, n_out, sb)
    rows = out_rows(rows_in, n_out, sb)
    out = torch.empty((blocks, rows, lanes), dtype=torch.int16,
                      device=values.device)
    work = torch.empty((blocks, sb * lanes, work_stride(rows // sb)),
                       dtype=torch.int16, device=values.device)
    rc = _kernels.library().dr_concentrate_tiled_vd(
        values.data_ptr(), disp.data_ptr(), out.data_ptr(), blocks, rows_in,
        lanes, rows, sb, work.data_ptr(), _kernels.stream(),
    )
    _kernels.check(rc, "concentrate_tiled_vd")
    _kernels.launches["concentrate_tiled_vd"] += 1
    return out


def tile(plane: torch.Tensor, sb: int, fill: int,
         lanes: int = 128) -> torch.Tensor:
    """(nseg, R) segment-major -> (blocks, R * sb, lanes) tiled, padding the
    segment axis to whole blocks of ``sb * lanes`` with ``fill``."""
    nseg, r = plane.shape
    bseg = sb * lanes
    blocks = -(-nseg // bseg)
    full = torch.full((blocks * bseg, r), fill, dtype=plane.dtype,
                      device=plane.device)
    full[:nseg] = plane
    return (full.reshape(blocks, sb, lanes, r).permute(0, 3, 1, 2)
            .reshape(blocks, r * sb, lanes).contiguous())


def untile(tiled: torch.Tensor, nseg: int, sb: int) -> torch.Tensor:
    """(blocks, R * sb, lanes) tiled -> (nseg, R) segment-major."""
    blocks, rows, lanes = tiled.shape
    r = rows // sb
    return (tiled.reshape(blocks, r, sb, lanes).permute(0, 2, 3, 1)
            .reshape(blocks * sb * lanes, r)[:nseg])


def staging_route(nseg: int, w: int, k: int):
    """The tiled staging the JAX exact decode (``unpack_decode_pallas``,
    ``unpack_pallas.py:400-485``, with its speculative branch on, as the
    JAX codec calls it) makes for ``nseg`` segments of ``w`` words:
    ``(mode, j, wc, sb)`` for :func:`decode_staging`, or None where it
    takes the untiled packed plane (B3) or no concentration kernel."""
    sb = 8 if nseg >= 1024 else 1 << max(-(-nseg // 128) - 1, 0).bit_length()
    j = min(-(-32 // (k + 1)), 32)

    def chunk_words(cap):
        wc = 16
        while wc * 2 * j * sb <= cap:
            wc *= 2
        return wc

    wc = chunk_words(8192)
    n_chunks = -(-w // wc)
    bound = (n_chunks * wc - 1) * (j - 1)
    slots = n_chunks * wc * j
    if bound < (1 << 15) and slots < (1 << 15):
        return None
    if slots <= (1 << 17):
        return ("packed" if bound < (1 << 15) else "bias"), j, wc, sb
    if slots <= (1 << 21):
        return "vd", j, chunk_words(4096), sb
    return None


def decode_staging(samples: torch.Tensor, k: int, w: int, j: int, wc: int,
                   sb: int, mode: str):
    """The tiled staging the JAX delta decode kernel
    (``unpack_pallas.py:171``, exact rate) emits for segments of
    ``samples``, each holding all ``samples.shape[1]`` samples.

    At word t the kernel decodes every codeword that starts in it, the
    jj-th into slot ``t * j + jj`` with displacement ``slot - n`` for
    sample n. The slot axis is ``ceil(w / wc) * wc * j`` for ``w`` words
    per segment and ``wc`` words per grid chunk.

    samples: (nseg, L) int16 decoded samples; mode: ``"packed"`` (one
    ``disp << 16 | halfword`` plane; every displacement must be < 2^15),
    ``"bias"`` (one sign-biased plane; < 2^16) or ``"vd"`` (int16 values
    and int32 displacements). Returns a tuple of tiled planes for
    :func:`concentrate_tiled` / :func:`concentrate_tiled_vd`.
    """
    nseg, length = samples.shape
    lens, _ = codeword_lengths_values(zigzag(prefilter_encode(samples)), k)
    start = torch.cumsum(lens, dim=1) - lens
    t = start >> 5
    n = torch.arange(length, device=samples.device).expand(nseg, length)
    new = torch.ones_like(t, dtype=torch.bool)
    new[:, 1:] = t[:, 1:] != t[:, :-1]
    first = torch.cummax(torch.where(new, n, 0), dim=1).values
    slot = t * j + (n - first)
    slots = -(-w // wc) * wc * j
    if int(slot[:, -1].max()) >= slots:
        raise ValueError("a codeword starts past the staged words")
    disp = slot - n
    half = samples.to(torch.int64) & 0xFFFF
    rows = torch.arange(nseg, device=samples.device)[:, None]
    if mode == "vd":
        vals = torch.zeros((nseg, slots), dtype=torch.int16,
                           device=samples.device)
        dsp = torch.full((nseg, slots), -1, dtype=torch.int32,
                         device=samples.device)
        vals[rows, slot] = samples
        dsp[rows, slot] = disp.to(torch.int32)
        return tile(vals, sb, 0), tile(dsp, sb, -1)
    field = {"packed": 15, "bias": 16}[mode]
    if int(disp.max()) >= (1 << field):
        raise ValueError(f"a displacement is past the {mode} plane's field")
    packed = (disp << 16) | half
    if mode == "bias":
        packed = packed ^ (1 << 31)
    plane = torch.full((nseg, slots), DEAD, dtype=torch.int32,
                       device=samples.device)
    plane[rows, slot] = as_i32(packed)
    return (tile(plane, sb, DEAD),)
