"""Device-side entropy encoder: RLE bit packing as jnp prefix sums + scatter.

The reference packs bits one code at a time in Python (reference:
pipeline/rle_byte_stream.py:48-58, util.py:115-132).  Here the whole band's
bitstream is assembled ON DEVICE inside jit:

1. Per-coefficient geometry (runs, sizes, chain counts) via masked running
   maxima and row prefix sums — the same formulas as the host codec
   (entropy/numpy_codec.py) and the size estimator (parallel/stats.py).
2. Every code unit's absolute bit offset comes from an exclusive prefix sum
   of unit lengths, plus the block's byte-aligned start offset.
3. Each unit value is positioned in a 32-bit window MSB-first and split into
   <= 4 bytes; bytes are deposited with one ``.at[].add(mode='drop')``
   scatter per byte lane.  Units never share bits, so per-byte sums cannot
   carry — add == bitwise-or here.

The output buffer is a static worst-case allocation (23 bits per coefficient
+ EOB, reference util.py:156 caps size at 15); the true length is returned
alongside so callers transfer only the used prefix.  Everything is int32/
uint32, so the production programs run with x64 off.

Decode is the dual: the host finds each block's start byte (the serial
O(bytes) boundary scan), and every block then parses in lock step on the
device (:func:`decode_stream`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

MAX_RUN = 15
MAX_SIZE = 15
MAX_AMP = (1 << (MAX_SIZE - 1)) - 1  # 16383

# Bit positions are int32 (x64 is off in production): one encode_stream call may
# address at most this many worst-case output bits.  Larger batches are
# split transparently by encode_stream_chunks (tests shrink this to
# exercise the chunking without gigabyte allocations).
_CAP_BITS = 2 ** 31


def worst_case_block_bytes(L: int) -> int:
    """Static per-block output bound: all coefficients nonzero at size 15."""
    return ((8 + MAX_SIZE) * L + 8 + 7) // 8


def max_chunk_blocks(L: int) -> int:
    """Largest block count whose worst-case bit positions stay in int32."""
    return max(1, (_CAP_BITS // 8 - 1) // worst_case_block_bytes(L))


def _geometry(levels):
    """Per-slot code geometry for (N, L) int32 levels."""
    nz = levels != 0
    absamp = jnp.abs(levels).astype(jnp.int32)
    # size = min(bit_length + 1, 15) from the f32 exponent field: |a| <
    # 2**24 converts exactly, so bits>>23 = 127 + floor(log2 a) and size =
    # (bits>>23) - 125 for a >= 1 (a|1 keeps a = 0 defined).  |amp| >
    # 16383 clamps to 15 either way — such levels make the stream
    # unrepresentable and callers reject them via the returned max before
    # using the buffer.  Zero slots report size = 0 (the nz mask is one
    # fused select; without it an unmasked consumer would silently emit
    # wrong size fields — the old frexp form's contract, kept on purpose).
    fbits = jax.lax.bitcast_convert_type(
        (absamp | 1).astype(jnp.float32), jnp.uint32)
    size = jnp.minimum((fbits >> 23).astype(jnp.int32) - 125, MAX_SIZE)
    size = jnp.where(nz, size, 0)

    L = levels.shape[-1]
    idx = jnp.arange(L, dtype=jnp.int32)
    marked = jnp.where(nz, idx, jnp.int32(-1))
    # Previous-nonzero via an UNROLLED shifted-max ladder: the explicit
    # slices fuse into one elementwise pass, where lax.associative_scan
    # materializes each level of its ladder.
    pmax = marked
    k = 1
    while k < L:
        shifted = jnp.concatenate(
            [jnp.full(pmax.shape[:-1] + (k,), -1, pmax.dtype),
             pmax[..., :-k]], axis=-1)
        pmax = jnp.maximum(pmax, shifted)
        k <<= 1
    prev = jnp.concatenate(
        [jnp.full(pmax.shape[:-1] + (1,), -1, dtype=pmax.dtype),
         pmax[..., :-1]], axis=-1)
    run = idx - prev - 1
    nchains = run // MAX_RUN
    rrem = run - nchains * MAX_RUN
    group_bits = jnp.where(nz, 8 * nchains + 8 + size, 0)
    return nz, absamp, size, nchains, rrem, group_bits


def _deposit(out, valid, byte0, window, nbytes):
    """Scatter the top ``nbytes`` bytes of each 32-bit window into ``out``."""
    oob = out.shape[0]
    for j in range(nbytes):
        b = ((window >> (24 - 8 * j)) & 0xFF).astype(jnp.int32)
        idx = jnp.where(valid, byte0 + j, oob)
        out = out.at[idx.reshape(-1)].add(b.reshape(-1), mode="drop")
    return out


def encode_stream(levels):
    """(N, L) int32 levels -> (bytes_u8[worst_case], blk_bytes (N,) int32).

    ``bytes_u8[: blk_bytes.sum()]`` is bit-identical to the host codec's
    output; the remainder is zero.  jit-safe, fully vectorized: every code
    unit's bit offset comes from prefix sums, and its bytes land with
    scatter-adds (units never share bits, so add == or).
    """
    n_blocks, L = levels.shape
    if n_blocks * worst_case_block_bytes(L) * 8 >= _CAP_BITS:
        # Bit positions are int32: ~256 MiB of worst-case output is the
        # per-call ceiling.  encode_stream_chunks self-splits.
        raise ValueError(
            f"{n_blocks} blocks of L={L} exceed the device encoder's int32 "
            f"bit-position range; use encode_stream_chunks")
    nz, absamp, size, nchains, rrem, group_bits = _geometry(levels)

    blk_bits = jnp.sum(group_bits, axis=-1) + 8          # + EOB
    blk_bytes = (blk_bits + 7) >> 3
    blk_start = jnp.cumsum(blk_bytes) - blk_bytes         # exclusive, bytes

    excl = jnp.cumsum(group_bits, axis=-1) - group_bits
    gpos = blk_start[:, None] * 8 + excl                  # unit-group bit pos

    out = jnp.zeros(n_blocks * worst_case_block_bytes(L), jnp.int32)

    # Zeros chains: 8-bit 0xF0 units before the code (util.py:146-154).
    cmax = (L - 1) // MAX_RUN
    for k in range(cmax):
        valid = nz & (k < nchains)
        pos = gpos + 8 * k
        byte0, off = pos >> 3, pos & 7
        window = jnp.uint32(0xF0) << (24 - off).astype(jnp.uint32)
        out = _deposit(out, valid, byte0, window, 2)

    # Code units: run(4) | size(4) | sign(1) | magnitude(size-1), MSB-first;
    # sign '1' = positive (util.py:120-123).
    sign = (levels > 0).astype(jnp.int32)
    v = ((rrem << (4 + size)) | (size << size)
         | (sign << (size - 1)) | absamp).astype(jnp.uint32)
    cl = 8 + size                                         # <= 23 bits
    cpos = gpos + 8 * nchains
    byte0, off = cpos >> 3, cpos & 7
    window = v << (32 - off - cl).astype(jnp.uint32)
    out = _deposit(out, nz, byte0, window, 4)

    return out.astype(jnp.uint8), blk_bytes


def decode_stream(stream_u8, starts, L: int):
    """Block-parallel device decode: (stream bytes, block start offsets) ->
    (N, L) int32 levels.

    The serial part of decode — finding where each block's bitstream starts
    — happens host-side in one O(bytes) scan (entropy.scan_offsets), which
    also validates the stream.  On device every block then advances in
    lockstep, one code per step:

    * The stream is pre-expanded once into per-byte 32-bit MSB-first windows
      (four shifted adds, no gather), so each step reads its code with a
      single gather.
    * Steps RECORD each decoded (position, amplitude) pair into dense
      (step, block) arrays — a contiguous dynamic-update-slice per step —
      instead of scattering into the (N, L) output every step.
    * The loop is a while_loop that exits when every block has hit EOB, so
      sparse content pays for its own code count, not the worst case
      (L + L//15 + 2 steps).  Its predicate is read back once per step.
    * Recorded positions are nondecreasing per block (runs only advance), so
      the final (N, L) assembly is a scatter-free vmapped binary search over
      the record axis.
    """
    n = starts.shape[0]
    nbytes = stream_u8.shape[0]
    if nbytes * 8 >= _CAP_BITS:
        raise ValueError(
            f"{nbytes}-byte stream exceeds the device decoder's int32 "
            f"bit-position range (~256 MiB); decode in smaller chunks")
    max_steps = L + L // MAX_RUN + 2

    # Per-byte big-endian 32-bit windows: w32[i] = bytes[i..i+4) (zero pad).
    p = jnp.concatenate([stream_u8.astype(jnp.uint32),
                         jnp.zeros(3, jnp.uint32)])
    w32 = ((p[:-3] << 24) | (p[1:-2] << 16) | (p[2:-1] << 8) | p[3:])

    def cond(carry):
        step, _, _, done, _, _ = carry
        return (step < max_steps) & ~jnp.all(done)

    def body(carry):
        step, pos, widx, done, wts, amps = carry
        active = ~done
        win = w32[jnp.minimum(pos >> 3, nbytes - 1)] << (pos & 7).astype(
            jnp.uint32)
        run = (win >> 28).astype(jnp.int32)
        size = ((win >> 24) & 0xF).astype(jnp.int32)
        is_eob = (run == 0) & (size == 0)
        is_chain = (run == MAX_RUN) & (size == 0)
        is_code = ~is_eob & ~is_chain

        sign = ((win >> 23) & 1).astype(jnp.int32)
        nmag = jnp.maximum(size - 1, 0)
        mag = ((win >> (23 - nmag).astype(jnp.uint32))
               & ((jnp.uint32(1) << nmag.astype(jnp.uint32)) - 1)
               ).astype(jnp.int32)
        amp = jnp.where(sign == 1, mag, -mag)

        wt = widx + run
        store = active & is_code & (wt < L)
        # Record row: decoded position (or the L sentinel) + amplitude.
        zero = jnp.int32(0)
        wts = jax.lax.dynamic_update_slice(
            wts, jnp.where(store, wt, jnp.int32(L))[None], (step, zero))
        amps = jax.lax.dynamic_update_slice(
            amps, jnp.where(store, amp, 0)[None], (step, zero))
        widx = jnp.where(active & is_chain, widx + MAX_RUN,
                         jnp.where(store, wt + 1, widx))
        adv = jnp.where(is_eob | is_chain, 8, 8 + size)
        newpos = pos + adv
        newpos = jnp.where(is_eob, (newpos + 7) & ~jnp.int32(7), newpos)
        pos = jnp.where(active, newpos, pos)
        done = done | (active & is_eob)
        return step + 1, pos, widx, done, wts, amps

    # Derive every carry init from the inputs so its "varying manual axes"
    # match the body outputs under shard_map (constants created here are
    # unvarying, while the body mixes in the sharded stream/starts; adding
    # a zero of the varying `starts` tags the init without changing it).
    v0 = starts.astype(jnp.int32) * 0
    init = (jnp.int32(0),
            starts.astype(jnp.int32) * 8,
            v0,
            v0 != 0,
            jnp.full((max_steps, n), L, jnp.int32) + v0[None, :],
            jnp.zeros((max_steps, n), jnp.int32) + v0[None, :])
    _, _, _, _, wts, amps = jax.lax.while_loop(cond, body, init)

    # (N, L) assembly: positions per block are nondecreasing except for the
    # L sentinels punched at non-store steps — repair with a running max
    # (the sentinel simply carries the last real position; its amplitude is
    # 0 so a duplicate hit contributes nothing when searched from the left).
    wtsT = jax.lax.associative_scan(jnp.maximum,
                                    jnp.where(wts == L, -1, wts),
                                    axis=0).T     # (N, S) nondecreasing < L
    ampsT = amps.T
    q = jnp.arange(L, dtype=jnp.int32)[None, :]   # (1, L) queries
    # First index with wtsT[row, idx] >= q: explicit fixed-depth binary
    # search (log2(S) take_along_axis rounds) — tiny, predictable HLO,
    # unlike vmapped jnp.searchsorted.
    n_rows = wtsT.shape[0]
    lo = jnp.zeros((n_rows, L), jnp.int32)        # invariant: wts[lo-1] < q
    hi = jnp.full((n_rows, L), max_steps, jnp.int32)   # wts[hi] >= q (virtual)
    steps_pow2 = max(1, (max_steps).bit_length())
    for _ in range(steps_pow2):
        mid = (lo + hi) >> 1
        v = jnp.take_along_axis(wtsT, jnp.minimum(mid, max_steps - 1), axis=1)
        below = v < q
        lo = jnp.where(below, mid + 1, lo)
        hi = jnp.where(below, hi, mid)
    idx = jnp.minimum(hi, max_steps - 1)
    hit = jnp.take_along_axis(wtsT, idx, axis=1) == q
    return jnp.where(hit, jnp.take_along_axis(ampsT, idx, axis=1), 0)


def encode_stream_chunks(levels):
    """(N, L) levels -> (bufs (C, chunk_worst) u8, blk_bytes (N,) int32).

    Self-chunking wrapper over :func:`encode_stream`: block batches whose
    worst-case output would overflow int32 bit positions split into C equal
    chunks (block boundaries are byte-aligned, so per-chunk streams
    concatenate into exactly the one-shot stream).  The tail chunk pads with
    all-zero blocks; each encodes to one EOB byte sitting AFTER the real
    blocks' bytes in that chunk's buffer, so pulling only the real blocks'
    byte total drops them.  jit-safe: C is static from the input shape.
    """
    n_blocks, L = levels.shape
    m = max_chunk_blocks(L)
    if n_blocks <= m:
        buf, blk_bytes = encode_stream(levels)
        return buf[None, :], blk_bytes
    c = -(-n_blocks // m)
    pad = c * m - n_blocks
    if pad:
        levels = jnp.concatenate(
            [levels, jnp.zeros((pad, L), levels.dtype)], axis=0)
    bufs, bbs = [], []
    for i in range(c):
        buf, bb = encode_stream(levels[i * m:(i + 1) * m])
        bufs.append(buf)
        bbs.append(bb)
    return jnp.stack(bufs), jnp.concatenate(bbs)[:n_blocks]


def assemble_chunks(bufs: "jax.Array", blk_bytes, chunk_blocks: int) -> bytes:
    """Host-side stitch of encode_stream_chunks output into stream bytes.

    ``chunk_blocks`` must be the cap the encoder traced with (pass the same
    value used to build the program — deriving it from shapes is ambiguous).
    Pulls only each chunk's used prefix (one transfer per chunk; C is 1 for
    everything under the int32 ceiling).
    """
    from ..utils.device import pull_prefix
    blk_bytes = np.asarray(blk_bytes)
    m = chunk_blocks
    parts = []
    for i in range(bufs.shape[0]):
        used = int(blk_bytes[i * m:(i + 1) * m].sum())
        parts.append(pull_prefix(bufs[i], used))
    return b"".join(parts)


def encode_bands_stream(levels, n_bands: int):
    """(B*N, L) levels of B equal bands -> (bytes_u8, band_bytes (B,), mx).

    Blocks are band-major, and every block's stream is byte-aligned, so the
    concatenated buffer splits into per-band streams at the returned byte
    counts.  ``mx`` is the max |level| for host-side representability
    checking (|amp| > 16383 cannot be coded; reference util.py:162-174).
    """
    stream, blk_bytes = encode_stream(levels)
    band_bytes = jnp.sum(blk_bytes.reshape(n_bands, -1), axis=-1)
    mx = jnp.max(jnp.abs(levels)).astype(jnp.int32)
    return stream, band_bytes, mx
