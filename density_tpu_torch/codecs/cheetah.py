"""Cheetah codec on int32 tensors: the encode planners, the parallel
decode (token extraction, value resolution, assembly) and one-shot
encode/decode.

Counterpart of the JAX package's `codecs/cheetah.py`. Wire format
(reference: cheetah.rs:42-203): 128-byte blocks of 32 quads, 2-bit flags
in a 64-bit LSB-first signature, a dual MRU-swapped dictionary
(chunk_a / chunk_b) per hash, and one prediction slot keyed by the
previous quad's hash.

Encode, as sorts: prediction_map[ctx] holds the quad of the latest
earlier position with the same context (the previous quad's hash), so a
quad is predicted <=> it equals the previous quad of its context group;
the dictionary is a 2-deep move-to-front list per hash over the
non-predicted quads, an MTF-2 scan within hash groups (each scan, in a
copy-free or a masked plan, is the span `engine.mtf2`). Decode: the
dictionary chain is flag-driven, one segmented scan; predicted values
come from a context fixpoint, iterated from the host until no stream
changes (`max_rounds` caps it; a stream still changing is redone on the
host by the caller).

Quads are int32 bit patterns; every right shift is masked.
"""

from __future__ import annotations

import torch

from density_tpu_torch.codecs.chameleon import BIAS, _sort_mod
from density_tpu_torch.constants import CHEETAH as SPEC
from density_tpu_torch.constants import (
    CHEETAH_MAP_A_FLAG, CHEETAH_MAP_B_FLAG, CHEETAH_PREDICTED_FLAG,
    HASH_MULTIPLIER_I32, OP_ID, OP_INS, OP_SWAP, PLAIN_FLAG)
from density_tpu_torch.engine import layout, unlayout
from density_tpu_torch.engine.grouping import (
    ctx_fill, hash_quads, mru2_state_in_group, prev_valid_value_in_group,
    seg_last_active_before, seg_mtf2_before, seg_mtf2_before_packed,
    seg_sel2_before, shift_right)
from density_tpu_torch.hostsync import read
from density_tpu_torch.kernels.packroute import signature_words
from density_tpu_torch.tracing import span

Q = SPEC.quads_per_block  # 32
SIG_WORDS = SPEC.sig_words  # 4
BLOCK = SPEC.block_size  # 128
FLAG_PLAIN, FLAG_MAP_A, FLAG_MAP_B, FLAG_PRED = (
    PLAIN_FLAG, CHEETAH_MAP_A_FLAG, CHEETAH_MAP_B_FLAG,
    CHEETAH_PREDICTED_FLAG)
MAX_ROUNDS = 12  # the context fixpoint's default cap (the JAX package's)


def _tokens(predicted, map_a, map_b, real, quads, h):
    """flags, payload words and the two payload halfwords of each quad."""
    plain = real & ~predicted & ~map_a & ~map_b
    flags = torch.where(predicted, FLAG_PRED,
                        torch.where(map_a, FLAG_MAP_A,
                                    torch.where(map_b, FLAG_MAP_B,
                                                FLAG_PLAIN)))
    pw = torch.where(real, torch.where(predicted, 0,
                                       torch.where(plain, 2, 1)), 0)
    w0 = torch.where(plain, quads & 0xFFFF, h)
    w1 = (quads >> 16) & 0xFFFF
    return flags.to(torch.int32), pw.to(torch.int32), w0, w1


def _contexts(hashes, valid):
    """ctx_i = hash of the latest valid quad before i (0 if none): the
    `last_hash` chain (cheetah.rs:148), which skips copy-block quads."""
    n = hashes.shape[-1]
    idx = torch.arange(n, device=hashes.device).expand_as(hashes)
    lv = shift_right(torch.cummax(torch.where(valid, idx, -1), dim=-1).values,
                     -1)
    return torch.where(lv >= 0, torch.gather(hashes, -1, lv.clamp(min=0)), 0)


def classify(quads, hashes, real, copy_blocks):
    """Per-quad tokens given the copy-block hypothesis (S, nb): quads in
    copy blocks neither emit tokens nor touch codec state. Returns
    (flags, pw, w0, w1, valid)."""
    valid = real & ~unlayout.per_quad(copy_blocks, Q)
    ctx = _contexts(hashes, valid)
    pred_val, _ = prev_valid_value_in_group(ctx, quads, valid, fill=0)
    predicted = valid & (quads == pred_val)
    dict_valid = valid & ~predicted
    with span("engine.mtf2"):
        front, second = mru2_state_in_group(hashes, quads, dict_valid)
    map_a = dict_valid & (quads == front)
    map_b = dict_valid & ~map_a & (quads == second)
    return (*_tokens(predicted, map_a, map_b, valid, quads, hashes), valid)


def sig_pack(flags_2d):
    """(..., 32) 2-bit flags, LSB-first -> (..., 4) u16 signature words."""
    return signature_words(flags_2d, Q, SIG_WORDS, 2).squeeze(-2)


def sig32(quads):
    """32-bit quad fingerprint whose equality is quad equality, carried
    through the sorts instead of the quad: the hash on top, then the
    product's bits 15..1 and the quad's top bit (`_sig32`). The
    multiplier is even with an odd half, so (hash, low bits, top bit)
    pins the quad, and sig32 == 0 <=> quad == 0."""
    prod = quads * HASH_MULTIPLIER_I32
    h = (prod >> 16) & 0xFFFF
    cmp16 = ((prod & 0xFFFF) >> 1) | (((quads >> 31) & 1) << 15)
    return (h << 16) | cmp16


def plan_fast(quads: torch.Tensor, nbytes: torch.Tensor):
    """Copy-free planner for (S, n_q) int32 quads, n_q a power of two:
    the port of `plan_fast_pallas`. Three sorts on the kernel of
    `_sort_mod`: by (context, index) carrying the fingerprint, by (hash,
    index) carrying the MTF payload, and back by index.

    n_q <= 2**16: each forward sort packs (group << 16 | index) into one
    biased key and carries one array. Above: 2-key 3-array sorts, as the
    JAX package makes them. Returns (flags, pw, w0, w1, real, bits)."""
    sort = _sort_mod().sort
    S, n_q = quads.shape
    dev = quads.device
    quads = quads.to(torch.int32)
    h = hash_quads(quads)
    lidx = torch.arange(n_q, dtype=torch.int32, device=dev)[None, :].expand(
        S, n_q)
    sig = sig32(quads)
    n_full = (nbytes.to(torch.int32) // 4)[:, None]
    real = lidx < n_full
    small = n_q <= (1 << 16)

    # prediction: the previous value in the context group; the dense
    # last_hash chain (copy-free): ctx_i = h_{i-1}, 0 at the start
    ctx = shift_right(h, 0)
    if small:
        kk_s, v_s = sort(((ctx << 16) | lidx) ^ BIAS, sig, n_keys=1)
        ku = kk_s ^ BIAS
        c_s = (ku >> 16) & 0xFFFF
        i_s = ku & 0xFFFF
    else:
        c_s, i_s, v_s = sort(ctx, lidx, sig, n_keys=2)
    same = c_s == shift_right(c_s, -1)
    real_ctx = i_s < n_full
    pred_s = torch.where(same, v_s == shift_right(v_s, 0), v_s == 0) & real_ctx

    # dictionary: MTF-2 over the non-predicted quads of each hash group,
    # sorted straight from the context order; the group is the
    # fingerprint's top half, the act/pred bits ride under the index
    h_ctx = (v_s >> 16) & 0xFFFF
    act_ctx = real_ctx & ~pred_s
    if small:
        # one 19-bit payload: the 16-bit in-group fingerprint, a bit that
        # keeps state 0 (quad 0) apart from a nonzero quad whose
        # fingerprint is 0, and the act/pred bits
        vp = (v_s & 0xFFFF) | torch.where(h_ctx != 0, 1 << 16, 0)
        payload = ((vp << 2) | (act_ctx.to(torch.int32) << 1)
                   | pred_s.to(torch.int32))
        kk_s, p_s = sort(((h_ctx << 16) | i_s) ^ BIAS, payload, n_keys=1)
        ku2 = kk_s ^ BIAS
        h_s = (ku2 >> 16) & 0xFFFF
        k2_s = ((ku2 & 0xFFFF) << 2) | (p_s & 3)
        v2 = p_s >> 2
        act_s = ((k2_s >> 1) & 1) == 1
        with span("engine.mtf2"):
            front, second = seg_mtf2_before_packed(
                h_s != shift_right(h_s, -1), v2, act_s)
    else:
        k2 = ((i_s << 2) | (act_ctx.to(torch.int32) << 1)
              | pred_s.to(torch.int32))
        h_s, k2_s, v2 = sort(h_ctx, k2, v_s, n_keys=2)
        act_s = ((k2_s >> 1) & 1) == 1
        with span("engine.mtf2"):
            front, second = seg_mtf2_before(h_s != shift_right(h_s, -1),
                                            v2, act_s)
    a_s = v2 == front
    b_s = ~a_s & (v2 == second)
    packed = (((k2_s >> 2) << 3) | ((k2_s & 1) << 2)
              | (a_s.to(torch.int32) << 1) | b_s.to(torch.int32))
    (up,) = sort(packed, n_keys=1)

    predicted = (((up >> 2) & 1) == 1) & real
    dict_valid = real & ~predicted
    map_a = dict_valid & (((up >> 1) & 1) == 1)
    map_b = dict_valid & ((up & 1) == 1)
    flags, pw, w0, w1 = _tokens(predicted, map_a, map_b, real, quads, h)
    bits = layout.incompressible_bits(pw, nbytes, Q, SIG_WORDS, BLOCK)
    return flags, pw, w0, w1, real, bits


PIPELINE = layout.Pipeline(name="cheetah", Q=Q, SIG_WORDS=SIG_WORDS,
                           BLOCK=BLOCK, flag_bits=SPEC.flag_bits,
                           plan_fast=plan_fast, classify=classify,
                           sig_pack=sig_pack)


def encode(data, device=None) -> bytes:
    """One-shot single-stream encode; density-compatible bytes."""
    return layout.encode_oneshot(PIPELINE, data, device)


def decode(data: bytes, device=None) -> bytes:
    """One-shot single-stream decode of a density cheetah stream."""
    from density_tpu_torch.parallel import sharding
    return sharding.decode_streams([bytes(data)], None, device,
                                   codec="cheetah")[0]


# ---------------------------------------------------------------------------
# Decode: tokens by gathers, values by a scan and a context fixpoint
# ---------------------------------------------------------------------------

def sig_unpack(sig_w):
    """(..., 4) u16 signature words -> (..., 32) 2-bit flags."""
    qq = torch.arange(Q, device=sig_w.device)
    return (sig_w[..., qq // 8] >> (2 * (qq % 8))) & 3


def extract_tokens(words, woff, is_copy, nb_real, out_len):
    """Per-quad (flags, w0, w1, valid) of staged streams (`_extract_tokens`
    over a batch): words (S, W) u16 values in int32, woff (S, NB) block
    word offsets, is_copy (S, NB), nb_real and out_len (S,). Tensor
    gathers, as the JAX package extracts cheetah tokens (no unpack
    kernel)."""
    return unlayout.gather_tokens(words, woff, is_copy, nb_real, out_len,
                                  SPEC, sig_unpack, FLAG_PRED)


def resolve(flags, w0, w1, valid, max_rounds: int = MAX_ROUNDS):
    """Batched value resolution (`_resolve_parallel_batched`), every sort
    on the kernel of `_sort_mod`. (S, N) tensors, N a power of two.

    The dictionary chain never involves predicted tokens, and every
    other token's hash group is on the wire, so plain/mapA/mapB values
    resolve in one segmented scan of flag-driven ops. A predicted token
    copies the latest non-predicted value of its context group, given
    the right contexts (ctx_i = the hash of token i-1: the wire's for a
    map token, as the reference keeps it, whatever quad its slot holds;
    the quad's for the others); contexts are unknown only after
    predicted tokens, so that pass iterates to its fixpoint, which is
    the unique solution. Each round after the first reads, on
    the host, whether any stream changed (one host sync a round).

    Returns (quads, ok, rounds): ok[s] is False where stream s still
    changed in the last of `rounds` rounds (it hit `max_rounds`)."""
    sort = _sort_mod().sort
    S, n_q = flags.shape
    dev = flags.device
    lidx = torch.arange(n_q, dtype=torch.int32, device=dev)[None, :].expand(
        S, n_q)
    plain_quad = w0 | (w1 << 16)
    is_pred = (flags == FLAG_PRED) & valid
    nonpred = valid & ~is_pred
    is_plain = (flags == FLAG_PLAIN) & valid

    # dictionary chain: exact, one pass
    key = torch.where(nonpred, torch.where(is_plain, hash_quads(plain_quad),
                                           w0), 1 << 16)
    op = torch.where(is_plain, OP_INS, torch.where(
        (flags == FLAG_MAP_B) & valid, OP_SWAP, OP_ID))
    op = torch.where(nonpred, op, OP_ID).to(torch.int32)
    k_s, k2_s, cv_s = sort(key, (lidx << 4) | (op << 2) | (flags & 3),
                           plain_quad, n_keys=2)
    a_b, b_b = seg_sel2_before(k_s != shift_right(k_s, -1), (k2_s >> 2) & 3,
                               cv_s)
    fl_s = k2_s & 3
    val_s = torch.where(fl_s == FLAG_MAP_A, a_b,
                        torch.where(fl_s == FLAG_MAP_B, b_b, cv_s))
    _, dv = sort(k2_s >> 4, val_s, n_keys=1)
    quads = torch.where(nonpred, dv, 0)

    # context fixpoint for the predicted tokens
    ckey_lo = (lidx << 1) | nonpred.to(torch.int32)
    changed = torch.ones(S, dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < max_rounds and (rounds == 0 or bool(read(changed.any()))):
        with span("engine.resolve_round"):
            ctx = ctx_fill(torch.where(nonpred, key, hash_quads(quads)),
                           valid)
            ck_s, ck2_s, q_s = sort(torch.where(valid, ctx, 1 << 16),
                                    ckey_lo, quads, n_keys=2)
            fill, _ = seg_last_active_before(ck_s != shift_right(ck_s, -1),
                                             q_s, (ck2_s & 1) == 1)
            _, pv = sort(ck2_s >> 1, fill, n_keys=1)
            new = torch.where(is_pred, pv, quads)
            changed = torch.any((new != quads) & is_pred, dim=1)
            quads = new
            rounds += 1
    # a stream unchanged in the last round is at its own fixpoint (its
    # update reads only its own positions), hence exactly decoded
    return quads, ~changed, rounds


def assemble(quads, valid, words, woff, is_copy, nb_real, out_len):
    """(S, NB * 64) output halfwords (`_assemble`): the resolved quads'
    halves where valid, a copy block's raw words over its own span."""
    return unlayout.assemble_quads(quads, valid, words, woff, is_copy,
                                   nb_real, out_len, BLOCK)


def decode_batch(words, woff, is_copy, nb_real, out_len,
                 max_rounds: int = MAX_ROUNDS):
    """Device decode of staged streams: (S, NB * 64) int32 halfwords, the
    (S,) converged flags and the fixpoint's rounds. NB * 32 must be a
    power of two."""
    flags, w0, w1, valid = extract_tokens(words, woff, is_copy, nb_real,
                                          out_len)
    quads, ok, rounds = resolve(flags, w0, w1, valid, max_rounds)
    return assemble(quads, valid, words, woff, is_copy, nb_real,
                    out_len), ok, rounds
