"""On-device boundary scan: find every block's start offset WITHOUT the host.

The boundary scan is the last serial O(bytes) stage of decode (the reference
parses the stream one code at a time, rle_byte_stream.py:74-88; our host
scanners in entropy/native/entropy.cpp and entropy/numpy_codec.py do the
same walk faster).  Block b+1's start depends on where block b ends, so the
chain looks irreducibly serial — but every block's bitstream is byte-aligned
(reference rle_byte_stream.py:54-56), which makes the set of possible block
starts small enough to brute-force:

1.  **Speculative per-byte parse** — for EVERY byte position q, a walker
    simulates the serial scan of "the block that starts at q": reads the
    4-bit run / 4-bit size header at its current bit position, advances
    (EOB -> pad to byte boundary and stop; 0xF0 zeros-chain -> +8 bits;
    code -> +8+size bits), tracks the coefficient index, and flags the same
    malformations the host scanner rejects (truncated stream, (run,0) with
    run not in {0,15}, coefficient index overflow, no EOB within the unit
    budget).  All walkers advance in lockstep — one vectorized step per
    unit, at most ``L + L//15 + 2`` steps (the host scanner's own bound).
    Result: ``E[q]`` = end byte of the block starting at q, or an absorbing
    ERR sentinel.

2.  **Wavefront join by pointer doubling** — the true starts are the orbit
    of 0 under E: ``s_0 = 0, s_{b+1} = E[s_b]``.  Squaring the table
    (``T <- T[T]``) doubles the orbit prefix per round, so ``num_blocks``
    starts materialize in ``ceil(log2(num_blocks+1))`` gathers.

3.  **One-scalar validation** — ERR is absorbing and E[q >= n] = ERR, so
    the stream is well-formed iff the orbit's element ``num_blocks`` equals
    exactly ``n_bytes`` (every earlier anomaly — mid-stream error, early
    termination, trailing bytes — propagates into that single comparison).
    The walk from a true start replays the host scanner's trajectory
    bit-for-bit, so when ``ok`` holds, the starts are exact by
    construction; when it doesn't, the caller reruns the host scanner to
    raise its canonical error.

All three phases are gather + elementwise XLA programs.  The host C++
scanner stays the default (:func:`scan_mode`); ``JPEG_TPU_SCAN=device``
selects this scan, which lets the API run scan, bit parse and IDCT of a
foreign stream as one host-free program (api._decode3_foreign_fn).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_RUN = 15


def _max_units(L: int) -> int:
    # Host scanners' per-block unit budget (numpy_codec.scan_offsets).
    return L + L // MAX_RUN + 2


def _end_table(stream, n_bytes, L: int):
    """Phase 1 for a padded uint8 stream buffer: (E over [0, P+1], ERR).

    ``E[q]`` = end byte of the block starting at byte q, or the absorbing
    ERR sentinel (P+1); ``n_bytes`` (traced) is the true buffer length for
    truncation detection.  A static-shaped gather+elementwise walk."""
    P = stream.shape[0]
    ERR = jnp.int32(P + 1)
    limit = n_bytes.astype(jnp.int32) * 8    # per-walker bit budget
    # 16-bit big-endian windows: any 8-bit header at bit position p lives in
    # w16[p >> 3] >> (8 - (p & 7)).  One shift+or pass, no per-step packing.
    b = jnp.concatenate([stream.astype(jnp.int32),
                         jnp.zeros(1, jnp.int32)])
    w16 = (b[:-1] << 8) | b[1:]

    # --- Phase 1: every byte is a candidate block start -------------------
    def step(st):
        it, pos, widx, done, err = st
        live = ~(done | err)
        trunc_hdr = pos + 8 > limit
        h = (w16[jnp.minimum(pos >> 3, P - 1)]
             >> (8 - (pos & 7))) & 0xFF
        run = h >> 4
        size = h & 0xF
        is_eob = h == 0
        is_chain = h == 0xF0
        is_code = size != 0
        bad_code = ~is_code & ~is_eob & ~is_chain
        trunc_code = is_code & (pos + 8 + size > limit)
        overflow = is_code & (widx + run >= L)
        new_err = live & (trunc_hdr | bad_code | trunc_code | overflow)

        adv = jnp.where(is_code, 8 + size, 8)
        npos = pos + adv
        npos = jnp.where(is_eob, (npos + 7) & ~jnp.int32(7), npos)
        nwidx = widx + jnp.where(is_chain, MAX_RUN,
                                 jnp.where(is_code, run + 1, 0))
        upd = live & ~new_err
        return (it + 1,
                jnp.where(upd, npos, pos),
                jnp.where(upd, nwidx, widx),
                done | (upd & is_eob),
                err | new_err)

    def not_settled(st):
        # Early exit once every walker hit EOB or an error: sparse streams
        # (short blocks) pay their own unit count, not the worst case.
        it, _, _, done, err = st
        return (it < _max_units(L)) & ~jnp.all(done | err)

    pos0 = jnp.arange(P, dtype=jnp.int32) * 8
    z = jnp.zeros(P, jnp.int32)
    _, pos, _, done, err = jax.lax.while_loop(
        not_settled, step, (jnp.int32(0), pos0, z, z != 0, z != 0))
    # E over the extended domain [0, P+1]: q=P (start at/after stream end)
    # and the ERR state itself both absorb to ERR.
    return jnp.concatenate([
        jnp.where(done & ~err, pos >> 3, ERR),
        jnp.full(2, ERR, jnp.int32)]), ERR


@functools.partial(jax.jit, static_argnames=("num_blocks", "L"))
def scan_table_and_starts(stream, n_bytes, num_blocks: int, L: int):
    """(padded stream bytes, true length) -> (starts (num_blocks,) i32, ok).

    ``stream`` is the zero-padded uint8 stream of static size P >= n_bytes;
    ``n_bytes`` is the true length (traced scalar).  ``ok`` is a scalar
    bool; ``starts`` is meaningful only when ``ok`` is True.
    """
    return scan_bands_starts(stream, jnp.reshape(n_bytes, (1,)),
                             num_blocks, L)


def scan_bands_starts(stream, ends, num_blocks: int, L: int):
    """In-program multi-band scan: ONE walker table over the concatenated
    band streams, then one orbit chase per band from its start offset.

    ``ends`` is the (B,) int32 cumulative band end offsets (band b occupies
    bytes [ends[b-1], ends[b])); every band has ``num_blocks`` blocks.
    Returns ``(starts (B*num_blocks,) i32, ok)`` — ok only when EVERY
    band's orbit lands exactly on its end offset.  E is monotonic
    (E[q] > q), so a band whose parse would consume the next band's bytes
    overshoots its end and fails the per-band check; composable inside a
    larger jit (api._decode3_foreign_fn fuses this with the bit parse and
    the coefficient decode into ONE dispatch).
    """
    E, ERR = _end_table(stream, ends[-1], L)
    B = ends.shape[0]
    # Pointer doubling, squaring HOISTED across bands: the T <- T[T]
    # ladder (the dominant P*log2(nb) gather cost) is independent of the
    # start offset, so all B orbits share one ladder.
    rounds = max(1, int(np.ceil(np.log2(num_blocks + 1))))
    nb_pad = 1 << rounds
    s0s = jnp.concatenate([jnp.zeros(1, jnp.int32),
                           ends[:-1].astype(jnp.int32)])
    orbit = jnp.zeros((B, nb_pad), jnp.int32).at[:, 0].set(s0s)
    T = E
    filled = 1
    for _ in range(rounds):
        nxt = T[orbit[:, :filled]]            # (B, filled)
        orbit = jax.lax.dynamic_update_slice(orbit, nxt, (0, filled))
        if 2 * filled < nb_pad:               # last squaring is unused
            T = T[T]
        filled *= 2
    starts = orbit[:, :num_blocks]
    endb = E[jnp.minimum(starts[:, num_blocks - 1], ERR)]
    ok = jnp.all(endb == ends.astype(jnp.int32))
    return starts.reshape(-1), ok


def scan_mode() -> str:
    """Boundary-scan policy for foreign streams: 'host' or 'device'.

    The host scanner (C++, or the pure-Python one where no compiler
    exists) is the default; ``JPEG_TPU_SCAN=device`` selects the device
    scan and, with it, the one-dispatch host-free decode.
    """
    import os
    v = os.environ.get("JPEG_TPU_SCAN", "").lower()
    return "device" if v == "device" else "host"


def scan_offsets_device(data: bytes, num_blocks: int, L: int):
    """Host wrapper: run the device scan on ``data``.

    Returns ``(starts int32 ndarray, ok bool)``.  Mirrors the host
    scanners' trivial cases exactly; for everything else the device
    program decides.  Does NOT raise on malformed streams — callers fall
    back to the host scanner for its canonical error (scan_offsets_hybrid).
    """
    from ..utils.device import quarter_cap

    n = len(data)
    if num_blocks == 0:
        return np.zeros(0, np.int32), n == 0
    if n == 0:
        return np.zeros(num_blocks, np.int32), False
    # Quarter-octave padding: every padded byte is a walker, so the pow2
    # cap's up-to-2x padding would be up-to-2x phase-1 work.
    pad = quarter_cap(n)
    arr = np.zeros(pad, np.uint8)
    arr[:n] = np.frombuffer(data, np.uint8)
    starts, ok = scan_table_and_starts(jnp.asarray(arr), jnp.int32(n),
                                       num_blocks, L)
    return np.asarray(starts), bool(ok)


def scan_offsets_hybrid(data: bytes, num_blocks: int, L: int) -> np.ndarray:
    """Device scan with host fallback: exact drop-in for
    ``entropy.scan_offsets`` (same result, same errors).

    Valid stream -> device-computed starts.  Anything malformed fails the
    device program's single ``ok`` check, and the host scanner reruns to
    raise its canonical error.
    """
    starts, ok = scan_offsets_device(data, num_blocks, L)
    if not ok:
        raise_rejected([data], num_blocks, L)
    return starts


def raise_rejected(streams, num_blocks: int, L: int):
    """Called when the device scan's ``ok`` flag failed: rerun the host
    scanner on each band stream to raise its canonical error.  A stream the
    host scanner accepts means the device scan itself is wrong; that is
    raised too, never papered over with the host's starts."""
    for s in streams:
        _host_scan(s, num_blocks, L)
    raise RuntimeError("device boundary scan rejected a stream the host "
                       "scanner accepts")


def _host_scan(data: bytes, num_blocks: int, L: int) -> np.ndarray:
    """The host scanner backends directly (NOT entropy.scan_offsets, which
    routes back here when JPEG_TPU_SCAN=device)."""
    from .. import entropy as E
    nat = E._get_native()
    if nat is not None:
        return nat.scan_offsets(data, num_blocks, L)
    from . import numpy_codec
    return numpy_codec.scan_offsets(data, num_blocks, L)
