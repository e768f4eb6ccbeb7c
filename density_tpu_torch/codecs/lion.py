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
each hash group (on the card the same kernel at K=2; the span
`engine.mtf2`). Every stream is padded to a power of two of at least
4096 quads (`layout.pad_quads`), so the planner always runs on the sort
kernel: the JAX package's XLA planner for other lengths
(`classify_fast`) has no counterpart here.

Decode is `unlayout`'s, shared with cheetah
(`unlayout.resolve_predicted`): the dictionary chain is flag-driven, one
segmented scan; the predicted values come from a context fixpoint whose
round (`_round`) scans the 5-slot queues (`grouping.seg_selq_before`),
iterated from the host until no stream changes (`max_rounds` caps it; a
stream still changing is redone on the host by the caller).

Quads are int32 bit patterns; every right shift is masked.
"""

from __future__ import annotations

from functools import partial

import torch

from density_tpu_torch.constants import BIAS
from density_tpu_torch.constants import LION as SPEC
from density_tpu_torch.constants import (
    LION_MAP_A_FLAG, LION_MAP_B_FLAG, LION_PREDICTED_A_FLAG, OP_ID, OP_INS,
    OP_SWAP, PLAIN_FLAG)
from density_tpu_torch.engine import layout, unlayout
from density_tpu_torch.engine.grouping import (
    contexts, hash_quads, mru2_state_in_group, seg_selq_before, shift_right,
    sig32, sort_module)
from density_tpu_torch.engine.mtf import (
    mtf2_depths_sorted, mtf_depths_in_group, mtf_depths_sorted)
from density_tpu_torch.kernels.packroute import signature_words
from density_tpu_torch.tracing import span

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
    ctx = contexts(hashes, valid)
    depth = mtf_depths_in_group(ctx, quads, valid, K)  # K: a miss
    dict_valid = valid & (depth >= K)
    with span("engine.mtf2"):
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
    `sort_module`: by (context, index) carrying the fingerprint, then the
    MTF-5 scan of the prediction queue; by (hash, index) carrying the
    dictionary's payload, then its MTF-2 scan; and back by index.

    n_q <= 2**16: each forward sort packs (group << 16 | index) into one
    biased key and carries one array (the second a 21-bit payload of
    fingerprint, act bit and depth). Above: 2-key 3-array sorts, as the
    JAX package makes them. Returns (flags, pw, w0, w1, real, bits)."""
    sort = sort_module().sort
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
    else:
        k2 = (i_s << 4) | (act_ctx << 3) | depth_s
        h_s, k2_s, v2 = sort(h_ctx, k2, v_s, n_keys=2)
    act_s = ((k2_s >> 3) & 1) == 1
    with span("engine.mtf2"):
        depth2 = mtf2_depths_sorted(h_s != shift_right(h_s, -1), v2, act_s)
    # the dictionary flags of active positions (the rest are masked in
    # `_tokens`)
    a_s = depth2 == 0
    b_s = depth2 == 1
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
# Decode: `unlayout`'s, bound to lion's flags, signature and round
# ---------------------------------------------------------------------------

def _round_tag(flags, nonpred, is_pred):
    """The context sort's tag of a position: its queue op (kind << 3) and
    the depth it reads (depth). A non-predicted quad shift-inserts its
    known value, a predicted one at depth d promotes slot d and reads
    it."""
    kind = torch.where(nonpred, OP_INS, torch.where(is_pred, OP_SWAP, OP_ID))
    return (kind << 3) | torch.clamp(flags - FLAG_PRED_A, 0, K - 1)


def _round(first, tags_s, quads_s):
    """A predicted token reads its depth of the 5-slot queue of its
    context group: one segmented scan of the queues' selection maps."""
    kind_s = (tags_s >> 3) & 3
    d_s = tags_s & 7
    before = seg_selq_before(first, kind_s,
                             torch.where(kind_s == OP_INS, 0, d_s), quads_s, K)
    return torch.gather(before, -1, d_s.long()[..., None])[..., 0]


extract_tokens = partial(unlayout.gather_tokens, spec=SPEC,
                         sig_unpack=sig_unpack, no_payload_flag=FLAG_PRED_A)
resolve = partial(unlayout.resolve_predicted, spec=SPEC,
                  map_flags=(FLAG_MAP_A, FLAG_MAP_B),
                  predicted=lambda flags: ((flags >= FLAG_PRED_A)
                                           & (flags < FLAG_PRED_A + K)),
                  round_tag=_round_tag, tag_bits=5, round_body=_round)
assemble = partial(unlayout.assemble_quads, block=BLOCK)
decode_batch = partial(unlayout.decode_predicted_batch,
                       extract=extract_tokens, resolve=resolve, block=BLOCK)
