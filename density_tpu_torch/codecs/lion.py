"""Lion codec on int32 tensors: the encode planners, the parallel decode
(token extraction, value resolution, assembly) and one-shot
encode/decode.

Counterpart of the JAX package's `codecs/lion.py`. Wire format
(reference: lion.rs:59-352): 64-byte blocks of 16 quads, 3-bit flags in
a 48-bit LSB-first signature (6 bytes), a dual MRU-swapped dictionary
(chunk_a / chunk_b) per hash, and a 5-deep prediction queue keyed by the
previous quad's hash. Flags: 0 plain, 1-5 predicted at queue depth 0-4,
6 map A, 7 map B; a prediction outranks the dictionary.

Encode, as sorts: the queue is a move-to-front list over the quads of
each context group, so every quad's predicted depth comes from one
segmented MTF-5 scan (`engine/mtf.py`) over the quads sorted by context;
the dictionary is cheetah's MTF-2 scan over the non-predicted quads of
each hash group. Every stream is padded to a power of two of at least
4096 quads (`layout.pad_quads`), so the planner always runs on the sort
kernel: the JAX package's XLA planner for other lengths
(`classify_fast`) has no counterpart here.

Decode: the dictionary chain is flag-driven, one segmented scan; the
predicted values come from a context fixpoint over the 5-slot queues
(`grouping.seg_selq_before`), iterated from the host until no stream
changes (`max_rounds` caps it; a stream still changing is redone on the
host by the caller).

Quads are int32 bit patterns; every right shift is masked.
"""

from __future__ import annotations

import torch

from density_tpu_torch.codecs.chameleon import BIAS, _sort_mod
from density_tpu_torch.codecs.cheetah import MAX_ROUNDS, _contexts, sig32
from density_tpu_torch.constants import LION as SPEC
from density_tpu_torch.constants import (
    LION_MAP_A_FLAG, LION_MAP_B_FLAG, LION_PREDICTED_A_FLAG, OP_ID, OP_INS,
    OP_SWAP, PLAIN_FLAG)
from density_tpu_torch.engine import layout, unlayout
from density_tpu_torch.engine.grouping import (
    ctx_fill, hash_quads, mru2_state_in_group, seg_mtf2_before,
    seg_mtf2_before_packed, seg_sel2_before, seg_selq_before, shift_right)
from density_tpu_torch.engine.mtf import mtf_depths_in_group, mtf_depths_sorted
from density_tpu_torch.kernels.packroute import signature_words

Q = SPEC.quads_per_block  # 16
SIG_WORDS = SPEC.sig_words  # 3
BLOCK = SPEC.block_size  # 64
FLAG_PLAIN, FLAG_PRED_A, FLAG_MAP_A, FLAG_MAP_B = (
    PLAIN_FLAG, LION_PREDICTED_A_FLAG, LION_MAP_A_FLAG, LION_MAP_B_FLAG)
K = 5  # prediction queue depth: flags FLAG_PRED_A .. FLAG_PRED_A + 4


def _tokens(depth, map_a, map_b, real, quads, h):
    """flags, payload words and the two payload halfwords of each quad;
    `depth` < K marks a predicted quad."""
    predicted = real & (depth < K)
    dict_valid = real & ~predicted
    map_a = dict_valid & map_a
    map_b = dict_valid & map_b
    plain = dict_valid & ~map_a & ~map_b
    flags = torch.where(predicted, depth + FLAG_PRED_A,
                        torch.where(map_a, FLAG_MAP_A,
                                    torch.where(map_b, FLAG_MAP_B,
                                                FLAG_PLAIN)))
    pw = torch.where(real, torch.where(predicted, 0,
                                       torch.where(plain, 2, 1)), 0)
    w0 = torch.where(plain, quads & 0xFFFF, h)
    w1 = (quads >> 16) & 0xFFFF
    return flags.to(torch.int32), pw.to(torch.int32), w0, w1


def classify(quads, hashes, real, copy_blocks):
    """Per-quad tokens given the copy-block hypothesis (S, nb): quads in
    copy blocks neither emit tokens nor touch codec state. Returns
    (flags, pw, w0, w1, valid)."""
    valid = real & ~unlayout.per_quad(copy_blocks, Q)
    ctx = _contexts(hashes, valid)
    depth = mtf_depths_in_group(ctx, quads, valid, K)  # K: a miss
    dict_valid = valid & (depth >= K)
    front, second = mru2_state_in_group(hashes, quads, dict_valid)
    map_a = quads == front
    map_b = ~map_a & (quads == second)
    return (*_tokens(depth, map_a, map_b, valid, quads, hashes), valid)


def sig_pack(flags_2d):
    """(..., 16) 3-bit flags, LSB-first -> (..., 3) u16 signature words
    (flag 10 straddles words 1 and 2)."""
    return signature_words(flags_2d, Q, SIG_WORDS, 3).squeeze(-2)


def sig_unpack(sig_w):
    """(..., 3) u16 signature words -> (..., 16) 3-bit flags. The words
    join into one 48-bit int64, so flag 10 (bits 30-32) needs no limb
    arithmetic and no shift sees a sign bit."""
    w = sig_w.to(torch.int64) & 0xFFFF
    sig = w[..., 0] | (w[..., 1] << 16) | (w[..., 2] << 32)
    shifts = 3 * torch.arange(Q, device=sig_w.device)
    return ((sig[..., None] >> shifts) & 7).to(torch.int32)


def plan_fast(quads: torch.Tensor, nbytes: torch.Tensor):
    """Copy-free planner for (S, n_q) int32 quads, n_q a power of two:
    the port of `plan_fast_pallas`. Three sorts on the kernel of
    `_sort_mod`: by (context, index) carrying the fingerprint, then the
    MTF-5 scan of the prediction queue; by (hash, index) carrying the
    dictionary's payload, then its MTF-2 scan; and back by index.

    n_q <= 2**16: each forward sort packs (group << 16 | index) into one
    biased key and carries one array (the second a 21-bit payload of
    fingerprint, act bit and depth). Above: 2-key 3-array sorts, as the
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

    # prediction queue: the MTF-5 depth in the context group; the dense
    # last_hash chain (copy-free): ctx_i = h_{i-1}, 0 at the start
    ctx = shift_right(h, 0)
    if small:
        kk_s, v_s = sort(((ctx << 16) | lidx) ^ BIAS, sig, n_keys=1)
        ku = kk_s ^ BIAS
        c_s = (ku >> 16) & 0xFFFF
        i_s = ku & 0xFFFF
    else:
        c_s, i_s, v_s = sort(ctx, lidx, sig, n_keys=2)
    real_ctx = i_s < n_full
    depth_s = mtf_depths_sorted(c_s != shift_right(c_s, -1), v_s, real_ctx, K)

    # dictionary: MTF-2 over the non-predicted quads of each hash group,
    # sorted straight from the context order; the group is the
    # fingerprint's top half, the act bit and depth ride under the index
    h_ctx = (v_s >> 16) & 0xFFFF
    act_ctx = (real_ctx & (depth_s >= K)).to(torch.int32)
    if small:
        # one 21-bit payload: the 16-bit in-group fingerprint, a bit that
        # keeps state 0 (quad 0) apart from a nonzero quad whose
        # fingerprint is 0, the act bit and the depth
        vp = (v_s & 0xFFFF) | torch.where(h_ctx != 0, 1 << 16, 0)
        payload = (vp << 4) | (act_ctx << 3) | depth_s
        kk_s, p_s = sort(((h_ctx << 16) | i_s) ^ BIAS, payload, n_keys=1)
        ku2 = kk_s ^ BIAS
        h_s = (ku2 >> 16) & 0xFFFF
        k2_s = ((ku2 & 0xFFFF) << 4) | (p_s & 15)
        v2 = p_s >> 4
        act_s = ((k2_s >> 3) & 1) == 1
        front, second = seg_mtf2_before_packed(
            h_s != shift_right(h_s, -1), v2, act_s)
    else:
        k2 = (i_s << 4) | (act_ctx << 3) | depth_s
        h_s, k2_s, v2 = sort(h_ctx, k2, v_s, n_keys=2)
        act_s = ((k2_s >> 3) & 1) == 1
        front, second = seg_mtf2_before(h_s != shift_right(h_s, -1), v2,
                                        act_s)
    a_s = v2 == front
    b_s = ~a_s & (v2 == second)
    packed = (((k2_s >> 4) << 5) | ((k2_s & 7) << 2)
              | (a_s.to(torch.int32) << 1) | b_s.to(torch.int32))
    (up,) = sort(packed, n_keys=1)

    flags, pw, w0, w1 = _tokens((up >> 2) & 7, ((up >> 1) & 1) == 1,
                                (up & 1) == 1, real, quads, h)
    bits = layout.incompressible_bits(pw, nbytes, Q, SIG_WORDS, BLOCK)
    return flags, pw, w0, w1, real, bits


PIPELINE = layout.Pipeline(name="lion", Q=Q, SIG_WORDS=SIG_WORDS,
                           BLOCK=BLOCK, flag_bits=SPEC.flag_bits,
                           plan_fast=plan_fast, classify=classify,
                           sig_pack=sig_pack)


def encode(data, device=None) -> bytes:
    """One-shot single-stream encode; density-compatible bytes."""
    return layout.encode_oneshot(PIPELINE, data, device)


def decode(data: bytes, device=None) -> bytes:
    """One-shot single-stream decode of a density lion stream."""
    from density_tpu_torch.parallel import sharding
    return sharding.decode_streams([bytes(data)], None, device,
                                   codec="lion")[0]


# ---------------------------------------------------------------------------
# Decode: tokens by gathers, values by a scan and a context fixpoint
# ---------------------------------------------------------------------------

def extract_tokens(words, woff, is_copy, nb_real, out_len):
    """Per-quad (flags, w0, w1, valid) of staged streams (`_extract_tokens`
    over a batch): words (S, W) u16 values in int32, woff (S, NB) block
    word offsets, is_copy (S, NB), nb_real and out_len (S,). Tensor
    gathers, as the JAX package extracts lion tokens (no unpack
    kernel)."""
    return unlayout.gather_tokens(words, woff, is_copy, nb_real, out_len,
                                  SPEC, sig_unpack, FLAG_PRED_A)


def resolve(flags, w0, w1, valid, max_rounds: int = MAX_ROUNDS):
    """Batched value resolution (`_resolve_parallel_batched`), every sort
    on the kernel of `_sort_mod`. (S, N) tensors, N a power of two.

    The dictionary chain never involves predicted tokens, and every
    other token's hash group is on the wire, so plain/mapA/mapB values
    resolve in one segmented scan of flag-driven ops. Given the contexts
    (ctx_i = hash of quad_{i-1}), the queue ops are flag-driven too (a
    non-predicted quad shift-inserts its known value, a predicted one at
    depth d promotes slot d and reads it), so the predicted values come
    from one segmented scan of the 5-slot selection maps; contexts are
    unknown only after predicted tokens, so that pass iterates to its
    fixpoint, which is the unique solution. Each round after the first
    reads, on the host, whether any stream changed (one host sync a
    round).

    Returns (quads, ok, rounds): ok[s] is False where stream s still
    changed in the last of `rounds` rounds (it hit `max_rounds`)."""
    sort = _sort_mod().sort
    S, n_q = flags.shape
    dev = flags.device
    lidx = torch.arange(n_q, dtype=torch.int32, device=dev)[None, :].expand(
        S, n_q)
    plain_quad = w0 | (w1 << 16)
    is_pred = (flags >= FLAG_PRED_A) & (flags < FLAG_PRED_A + K) & valid
    nonpred = valid & ~is_pred
    is_plain = (flags == FLAG_PLAIN) & valid

    # dictionary chain: exact, one pass
    key = torch.where(nonpred, torch.where(is_plain, hash_quads(plain_quad),
                                           w0), 1 << 16)
    op = torch.where(is_plain, OP_INS, torch.where(
        (flags == FLAG_MAP_B) & valid, OP_SWAP, OP_ID))
    op = torch.where(nonpred, op, OP_ID).to(torch.int32)
    k_s, k2_s, cv_s = sort(key, (lidx << 5) | (op << 3) | flags, plain_quad,
                           n_keys=2)
    a_b, b_b = seg_sel2_before(k_s != shift_right(k_s, -1), (k2_s >> 3) & 3,
                               cv_s)
    fl_s = k2_s & 7
    val_s = torch.where(fl_s == FLAG_MAP_A, a_b,
                        torch.where(fl_s == FLAG_MAP_B, b_b, cv_s))
    _, dv = sort(k2_s >> 5, val_s, n_keys=1)
    quads = torch.where(nonpred, dv, 0)

    # context fixpoint over the 5-slot queues
    kind = torch.where(nonpred, OP_INS, torch.where(is_pred, OP_SWAP, OP_ID))
    depth = torch.clamp(flags - FLAG_PRED_A, 0, K - 1)
    ck2 = ((lidx << 5) | (kind << 3) | depth).to(torch.int32)
    changed = torch.ones(S, dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < max_rounds and (rounds == 0 or bool(changed.any())):
        ctx = ctx_fill(hash_quads(quads), valid)
        ck_s, ck2_s, q_s = sort(torch.where(valid, ctx, 1 << 16), ck2, quads,
                                n_keys=2)
        kind_s = (ck2_s >> 3) & 3
        d_s = ck2_s & 7
        before = seg_selq_before(ck_s != shift_right(ck_s, -1), kind_s,
                                 torch.where(kind_s == OP_INS, 0, d_s), q_s,
                                 K)
        read_s = torch.gather(before, -1, d_s.long()[..., None])[..., 0]
        _, pv = sort(ck2_s >> 5, read_s, n_keys=1)
        new = torch.where(is_pred, pv, quads)
        changed = torch.any((new != quads) & is_pred, dim=1)
        quads = new
        rounds += 1
    # a stream unchanged in the last round is at its own fixpoint (its
    # update reads only its own positions), hence exactly decoded
    return quads, ~changed, rounds


def assemble(quads, valid, words, woff, is_copy, nb_real, out_len):
    """(S, NB * 32) output halfwords (`_assemble`): the resolved quads'
    halves where valid, a copy block's raw words over its own span."""
    return unlayout.assemble_quads(quads, valid, words, woff, is_copy,
                                   nb_real, out_len, BLOCK)


def decode_batch(words, woff, is_copy, nb_real, out_len,
                 max_rounds: int = MAX_ROUNDS):
    """Device decode of staged streams: (S, NB * 32) int32 halfwords, the
    (S,) converged flags and the fixpoint's rounds. NB * 16 must be a
    power of two."""
    flags, w0, w1, valid = extract_tokens(words, woff, is_copy, nb_real,
                                          out_len)
    quads, ok, rounds = resolve(flags, w0, w1, valid, max_rounds)
    return assemble(quads, valid, words, woff, is_copy, nb_real,
                    out_len), ok, rounds
