"""Decode-side layout engine: batched token extraction, chameleon map
resolution on the sort kernel, and the token gathers and output assembly
that cheetah and lion share.

Counterpart of the JAX package's `engine/unlayout.py` (its kernel
branch). Reference semantics (chameleon.rs:105-135): a MAP token
resolves to the nearest preceding PLAIN token with the same hash,
because maps never modify the dictionary; first-in-group maps read the
zero-initialized dictionary (value 0). Cheetah's and lion's tokens come
from tensor gathers, as the JAX package extracts them (`_extract_tokens`
of each codec, over a batch), and their quads are laid out by
`assemble_quads` (each codec's `_assemble`).
"""

from __future__ import annotations

import torch

from density_tpu_torch.constants import CHAMELEON as SPEC
from density_tpu_torch.constants import HASH_MULTIPLIER_I32
from density_tpu_torch.engine.grouping import hash_quads, monoid_scan, shift_right
from density_tpu_torch.kernels import bigsort, unpack

INV_MHALF = 0x11B00B23  # (HASH_MULTIPLIER >> 1)^-1 mod 2^31
BIAS = -2**31


def quad_cmp16(quad):
    """16-bit exact quad fingerprint given the hash: the low product bits
    (their LSB is always 0 -- the multiplier is even) plus the quad's top
    bit. (hash, cmp16) <-> quad is a bijection."""
    prod = quad.to(torch.int32) * HASH_MULTIPLIER_I32
    return ((prod & 0xFFFF) >> 1) | (((quad >> 31) & 1) << 15)


def quad_from_cmp16(h, c16):
    """Invert (hash, cmp16) -> quad (int32 bit pattern)."""
    t = (c16 & 0x7FFF) << 1
    P = (h.to(torch.int32) << 16) | t
    qlow = (((P >> 1) & 0x7FFFFFFF) * INV_MHALF) & 0x7FFFFFFF
    return qlow | ((c16 & 0x8000) << 16)


def seg_fill_last_nonzero(x, first):
    """Row-wise segmented INCLUSIVE fill of the latest nonzero value
    (0 = nothing yet), segments starting where `first` is set: plain
    Hillis-Steele doubling, log2(n) shifted combines."""

    def combine(a, b):
        va, fa = a
        vb, fb = b
        v = torch.where(fb, vb, torch.where(vb != 0, vb, va))
        return v, fa | fb

    v, _ = monoid_scan(combine, (x, first), (0, False))
    return v


def resolve_chameleon(is_map, is_plain, h, plain_quad):
    """Resolve map tokens. All inputs (S, N), N a power of two. A map's
    value is the payload quad of the latest preceding plain token with
    the same hash (0 if none). Two sorts: forward by (hash, index)
    carrying (is_plain, fingerprint), back by index carrying the
    resolved quad; between them a doubling fill of the latest plain
    fingerprint, inverted to the quad from (hash, fingerprint)."""
    S, N = is_map.shape
    dev = is_map.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    c16 = quad_cmp16(plain_quad)
    isp32 = is_plain.to(torch.int32)
    if N <= (1 << 16):
        kk = ((h << 16) | idx) ^ BIAS
        v = (isp32 << 16) | torch.where(is_plain, c16, 0)
        kk_s, v_s = bigsort.sort(kk, v, n_keys=1)
        ku = kk_s ^ BIAS
        grp = (ku >> 16) & 0xFFFF
        idx_back = ku & 0xFFFF
        isp = ((v_s >> 16) & 1) == 1
        c16s = v_s & 0xFFFF
    else:
        sbh = (N - 1).bit_length() - 15  # index bits above 15
        k1 = (h << sbh) | (idx >> 15)
        k2 = (((idx & 0x7FFF) << 17) | (isp32 << 16)
              | torch.where(is_plain, c16, 0)) ^ BIAS
        k1s, k2s = bigsort.sort(k1, k2, n_keys=2)
        k2u = k2s ^ BIAS
        grp = k1s >> sbh
        idx_back = ((k1s & ((1 << sbh) - 1)) << 15) | ((k2u >> 17) & 0x7FFF)
        isp = ((k2u >> 16) & 1) == 1
        c16s = k2u & 0xFFFF
    first = grp != shift_right(grp, -1)
    # the 'has' bit rides above the 16 fingerprint bits; inclusive ==
    # exclusive for readers (a map is never a writer at its position)
    x = torch.where(isp, (1 << 16) | c16s, 0)
    fill = seg_fill_last_nonzero(x, first)
    q_rec = quad_from_cmp16(grp, fill & 0xFFFF)
    resolved_s = torch.where(fill != 0, q_rec, 0)
    _, vr = bigsort.sort(idx_back, resolved_s, n_keys=1)
    return torch.where(is_map, vr, plain_quad)


def decode_chameleon_batch(words, woff, is_copy, nb_real, out_len):
    """Batched chameleon decode on the unpack and sort kernels.

    words: (S, W) u16 values of the compressed streams; woff: (S, NB)
    int32 block word offsets; is_copy: (S, NB) bool; nb_real, out_len:
    (S,) int32. NB * 64 must be a power of two. Returns (S, NB * 128)
    int32 output halfwords and unpack's one-element malformed-block flag,
    both on the device (as the reference's decode returns its words and
    ok flags); the caller reads the flag with the words and stamps the
    ragged-tail bytes on the host."""
    Q = SPEC.quads_per_block
    S, _ = words.shape
    NB = woff.shape[1]
    N = NB * Q
    dev = words.device
    bidx = torch.arange(NB, device=dev)[None, :]
    is_real_block = bidx < nb_real[:, None]
    kidx = torch.arange(N, device=dev)[None, :]
    real = kidx < (out_len[:, None] // 4)

    woff_k = torch.where(is_real_block, woff, -1)
    flags, w0, w1, bad = unpack.unpack_flagged(
        words, woff_k, is_copy, q=Q, sig_words=SPEC.sig_words,
        flag_bits=SPEC.flag_bits)
    blk_ok = is_real_block & ~is_copy

    def per_quad(x):  # per block -> per quad, with no host sync
        return x[:, :, None].expand(S, NB, Q).reshape(S, N)

    valid = real & per_quad(blk_ok)
    is_map = (flags == 1) & valid
    is_plain = valid & ~is_map
    plain_quad = w0 | (w1 << 16)
    h = torch.where(is_map, w0, hash_quads(plain_quad))
    quads = resolve_chameleon(is_map, is_plain, h, plain_quad)

    # copy blocks come out of unpack as raw halfword pairs; the ragged
    # final quad of a trailing copy block is real data too
    real_pad = kidx < ((out_len[:, None] + 3) // 4)
    in_copy = real_pad & per_quad(is_copy & is_real_block)
    quads = torch.where(in_copy, plain_quad, quads)
    valid = valid | in_copy
    lo = torch.where(valid, quads & 0xFFFF, 0)
    hi = torch.where(valid, (quads >> 16) & 0xFFFF, 0)
    return torch.stack([lo, hi], dim=-1).reshape(S, 2 * N), bad


def per_quad(blocks, q: int):
    """(S, nb) per-block values -> (S, nb * q) per quad."""
    S, nb = blocks.shape
    return blocks[:, :, None].expand(S, nb, q).reshape(S, nb * q)


def gather_tokens(words, woff, is_copy, nb_real, out_len, spec, sig_unpack,
                  no_payload_flag: int):
    """Per-quad (flags, w0, w1, valid) of staged cheetah or lion streams:
    words (S, W) u16 values in int32, woff (S, NB) block word offsets,
    is_copy (S, NB), nb_real and out_len (S,). `sig_unpack` turns (S, NB,
    sig_words) signature words into (S, NB, q) flags; a position without
    a token (past the data, in a copy or dead block) gets
    `no_payload_flag`, a flag with no payload. A gather past the words
    reads the last word."""
    Q, SW = spec.quads_per_block, spec.sig_words
    S, NB = woff.shape
    cap = words.shape[1]
    dev = words.device
    n_q = NB * Q
    is_real_block = torch.arange(NB, device=dev)[None, :] < nb_real[:, None]

    def gather(pos):
        return torch.gather(words, 1, pos.clamp(0, cap - 1).reshape(S, -1))

    sig_w = gather(woff[:, :, None] + torch.arange(SW, device=dev))
    flags = sig_unpack(sig_w.reshape(S, NB, SW)).reshape(S, n_q)
    real = (torch.arange(n_q, device=dev)[None, :]
            < (out_len.to(torch.int32) // 4)[:, None])
    valid = real & per_quad(~is_copy & is_real_block, Q)
    flags = torch.where(valid, flags, no_payload_flag)
    pw = torch.where(valid, unpack.flag_payload_words(flags, spec.flag_bits),
                     0).reshape(S, NB, Q)
    pos = woff[:, :, None] + SW + torch.cumsum(pw, 2) - pw
    return (flags.to(torch.int32), gather(pos), gather(pos + 1), valid)


def assemble_quads(quads, valid, words, woff, is_copy, nb_real, out_len,
                   block: int):
    """(S, NB * block / 2) output halfwords (each codec's `_assemble`):
    the resolved quads' halves where valid, a copy block's raw words over
    its own span."""
    S, NB = woff.shape
    cap = words.shape[1]
    dev = words.device
    wpb = block // 2
    bidx = torch.arange(NB, device=dev)[None, :]
    lo = torch.where(valid, quads & 0xFFFF, 0)
    hi = torch.where(valid, (quads >> 16) & 0xFFFF, 0)
    out = torch.stack([lo, hi], dim=-1).reshape(S, NB, wpb)
    j = torch.arange(wpb, device=dev)
    blen = torch.clamp(out_len[:, None] - bidx * block, 0, block)
    cmask = ((is_copy & (bidx < nb_real[:, None]))[:, :, None]
             & (j < ((blen + 1) // 2)[:, :, None]))
    src = (woff[:, :, None] + j).clamp(0, cap - 1).reshape(S, -1)
    raw = torch.gather(words, 1, src).reshape(S, NB, wpb)
    return torch.where(cmask, raw, out).reshape(S, NB * wpb)
