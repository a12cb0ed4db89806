"""Device pileup for gapless, pre-gated reads.

The host has already run mate-overlap arbitration and the phred gate, so a
read reaches the device as one row of base codes in which every base that
must not be counted carries code 0. Each row covers the contiguous
coordinates start, start+1, ... of the window (or of a group of windows laid
side by side), so the whole pileup is one integer scatter-add over
(strand parity, channel, start + column). Integer adds are exact in any
order, so the result is identical to ops.semantics.pileup_channels however
the device schedules them.

The reference-dependent channel math (meth/unmeth/opposite/variant,
extract.c:420-441) runs afterwards as window-wide selects.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 1, 2, 4, 8, 15
REF_C, REF_G = ord("C"), ord("G")

# 4-bit base code -> per-parity channel of pileup_base_counts: A, C, G, T,
# N are channels 1-5, every other nonzero code (ambiguity codes) channel 6,
# code 0 (gated out / padding) is not counted.
_BASE_CHANNEL = np.full(16, 6, np.uint8)
_BASE_CHANNEL[0] = 0
for _ch, _code in enumerate((BASE_A, BASE_C, BASE_G, BASE_T, BASE_N), 1):
    _BASE_CHANNEL[_code] = _ch


def pileup_counts(chan, start, parity, W: int, nchan: int):
    """Scatter-add of one count per nonzero entry of `chan`.

    chan: uint8 [N, L], the channel (1..nchan) of each base, 0 = not
    counted; start: int32 [N], the coordinate of each row's column 0
    (may be negative); parity: [N], strand parity (1 = odd: OT/CTOT).
    Returns int32 [2, nchan, W] indexed [1 - parity, channel - 1, coord].
    Bases outside [0, W) are dropped."""
    N, L = chan.shape
    col = start.astype(jnp.int32)[:, None] + jnp.arange(L, dtype=jnp.int32)
    row = (1 - parity.astype(jnp.int32))[:, None] * nchan
    flat = (row + chan.astype(jnp.int32) - 1) * W + col
    ok = (chan != 0) & (col >= 0) & (col < W)
    idx = jnp.where(ok, flat, 2 * nchan * W)
    counts = jnp.zeros(2 * nchan * W, jnp.int32)
    counts = counts.at[idx.reshape(-1)].add(1, mode="drop")
    return counts.reshape(2, nchan, W)


def pileup_base_counts(codes, start, parity, W: int):
    """Per-parity base counts for 4-bit base codes: int32 [2, 6, W] with
    rows (total, A, C, G, T, N) for [odd, even] parity. `total` counts
    every nonzero code, ambiguity codes included."""
    chan = jnp.asarray(_BASE_CHANNEL)[codes.astype(jnp.int32)]
    c = pileup_counts(chan, start, parity, W, 6)
    total = jnp.sum(c, axis=1, keepdims=True)
    return jnp.concatenate([total, c[:, :5]], axis=1)


def unpack_bits_device(packed, W):
    """[ceil(W/8)] packed bits (np.packbits big-endian order) → bool [W]."""
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (packed[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1)[:W] != 0


def channels_nch2(counts, isc_bits, isg_bits, W):
    """Epilogue for the 2-bit semantic coding: counts int32 [2, 2, W] from
    pileup_counts(nchan=2) (channel 1 = the strand's methylated base, 2 =
    its unmethylated base) + host-packed per-coordinate reference masks →
    [2, W] uint32 (meth, unmeth). The host already applied the window/ref
    frame shift when packing isc/isg."""
    is_c = unpack_bits_device(isc_bits, W)
    is_g = unpack_bits_device(isg_bits, W)
    odd, even = counts[0], counts[1]
    meth = jnp.where(is_c, odd[0], jnp.where(is_g, even[0], 0))
    unmeth = jnp.where(is_c, odd[1], jnp.where(is_g, even[1], 0))
    return jnp.stack([meth, unmeth], axis=0).astype(jnp.uint32)


def counts_to_channels(counts, ref_window, win_offset_rel, W):
    """Per-parity base counts [2, 6, W] (pileup_base_counts) → the 4
    reference-dependent channels of extract.c:420-441 (meth, unmeth,
    opposite coverage, opposite variants) as uint32 [4, W]."""
    counts = jnp.asarray(counts)
    ref = jnp.asarray(ref_window)
    # refb[i] = ref[i - win_offset_rel] (0 outside). PAD bounds
    # |win_offset_rel|: the engine fetches ref from win_start-2, so the
    # offset is a small negative number (extract.c:379-381's localPos2-2).
    PAD = 512
    if isinstance(win_offset_rel, int):
        # dynamic_slice clamps out-of-range starts silently; guard the
        # assumption whenever the offset is concrete (traced callers assert
        # it on the host before dispatch).
        assert -(ref.shape[0] + PAD) <= win_offset_rel <= PAD, win_offset_rel
    padded = jnp.concatenate([jnp.zeros(PAD, ref.dtype), ref,
                              jnp.zeros(W + PAD, ref.dtype)])
    refb = jax.lax.dynamic_slice(padded, (PAD - win_offset_rel,), (W,))
    odd, even = counts[0], counts[1]
    tot, a, c, g, t, n = range(6)
    is_c = refb == REF_C
    is_g = refb == REF_G
    meth = jnp.where(is_c, odd[c], jnp.where(is_g, even[g], 0))
    unmeth = jnp.where(is_c, odd[t], jnp.where(is_g, even[a], 0))
    var_odd = odd[tot] - odd[g] - odd[n]
    var_even = even[tot] - even[c] - even[n]
    off = jnp.where(is_c, even[tot],
                    jnp.where(is_g, odd[tot], odd[tot] + even[tot]))
    var = jnp.where(is_c, var_even,
                    jnp.where(is_g, var_odd, var_odd + var_even))
    return jnp.stack([meth, unmeth, off, var], axis=0).astype(jnp.uint32)
