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
non-predicted quads, an MTF-2 scan within hash groups (the copy-free
plan's is `engine/mtf.py::mtf2_depths_sorted`, one launch of the MTF
kernel at K=2 on the card; each scan, in a copy-free or a masked plan,
is the span `engine.mtf2`). Decode is
`unlayout`'s, shared with lion (`unlayout.resolve_predicted`): the
dictionary chain is flag-driven, one segmented scan; predicted values
come from a context fixpoint whose round (`_round`) fills each
predicted token with the latest non-predicted value of its context
group, iterated from the host until no stream changes (`max_rounds`
caps it; a stream still changing is redone on the host by the caller).

Quads are int32 bit patterns; every right shift is masked.
"""

from __future__ import annotations

from functools import partial

import torch

from density_tpu_torch.constants import BIAS
from density_tpu_torch.constants import CHEETAH as SPEC
from density_tpu_torch.constants import (
    CHEETAH_MAP_A_FLAG, CHEETAH_MAP_B_FLAG, CHEETAH_PREDICTED_FLAG,
    PLAIN_FLAG)
from density_tpu_torch.engine import layout, unlayout
from density_tpu_torch.engine.grouping import (
    contexts, hash_quads, mru2_state_in_group, prev_valid_value_in_group,
    seg_last_active_before, shift_right, sig32, sort_module)
from density_tpu_torch.engine.mtf import mtf2_depths_sorted
from density_tpu_torch.kernels.packroute import signature_words
from density_tpu_torch.tracing import span

Q = SPEC.quads_per_block  # 32
SIG_WORDS = SPEC.sig_words  # 4
BLOCK = SPEC.block_size  # 128
FLAG_PLAIN, FLAG_MAP_A, FLAG_MAP_B, FLAG_PRED = (
    PLAIN_FLAG, CHEETAH_MAP_A_FLAG, CHEETAH_MAP_B_FLAG,
    CHEETAH_PREDICTED_FLAG)


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


def classify(quads, hashes, real, copy_blocks):
    """Per-quad tokens given the copy-block hypothesis (S, nb): quads in
    copy blocks neither emit tokens nor touch codec state. Returns
    (flags, pw, w0, w1, valid)."""
    valid = real & ~unlayout.per_quad(copy_blocks, Q)
    ctx = contexts(hashes, valid)
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


def plan_fast(quads: torch.Tensor, nbytes: torch.Tensor):
    """Copy-free planner for (S, n_q) int32 quads, n_q a power of two:
    the port of `plan_fast_pallas`. Three sorts on the kernel of
    `sort_module`: by (context, index) carrying the fingerprint, by (hash,
    index) carrying the MTF payload, and back by index.

    n_q <= 2**16: each forward sort packs (group << 16 | index) into one
    biased key and carries one array. Above: 2-key 3-array sorts, as the
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
    else:
        k2 = ((i_s << 2) | (act_ctx.to(torch.int32) << 1)
              | pred_s.to(torch.int32))
        h_s, k2_s, v2 = sort(h_ctx, k2, v_s, n_keys=2)
    act_s = ((k2_s >> 1) & 1) == 1
    with span("engine.mtf2"):
        depth2 = mtf2_depths_sorted(h_s != shift_right(h_s, -1), v2, act_s)
    # the dictionary flags of active positions (the rest are masked below)
    a_s = depth2 == 0
    b_s = depth2 == 1
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
# Decode: `unlayout`'s, bound to cheetah's flags, signature and round
# ---------------------------------------------------------------------------

def sig_unpack(sig_w):
    """(..., 4) u16 signature words -> (..., 32) 2-bit flags."""
    qq = torch.arange(Q, device=sig_w.device)
    return (sig_w[..., qq // 8] >> (2 * (qq % 8))) & 3


def _round_tag(flags, nonpred, is_pred):
    """The context sort's tag of a position: whether it is non-predicted."""
    return nonpred.to(torch.int32)


def _round(first, tags_s, quads_s):
    """A predicted token copies the latest non-predicted value of its
    context group (the prediction slot)."""
    fill, _ = seg_last_active_before(first, quads_s, (tags_s & 1) == 1)
    return fill


extract_tokens = partial(unlayout.gather_tokens, spec=SPEC,
                         sig_unpack=sig_unpack, no_payload_flag=FLAG_PRED)
resolve = partial(unlayout.resolve_predicted, spec=SPEC,
                  map_flags=(FLAG_MAP_A, FLAG_MAP_B),
                  predicted=lambda flags: flags == FLAG_PRED,
                  round_tag=_round_tag, tag_bits=1, round_body=_round)
assemble = partial(unlayout.assemble_quads, block=BLOCK)
decode_batch = partial(unlayout.decode_predicted_batch,
                       extract=extract_tokens, resolve=resolve, block=BLOCK)
