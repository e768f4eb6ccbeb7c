"""Chameleon codec on int32 tensors: the encode planners and one-shot
encode/decode.

Counterpart of the JAX package's `codecs/chameleon.py`. Wire format
(reference: chameleon.rs:34-151): 256-byte blocks of 64 quads, 1-bit
flags in a 64-bit LSB-first signature, payloads are u32 quads (plain)
or u16 hashes (map), one 2^16-entry dictionary.

The dictionary slot dict[h] always holds the quad of the latest earlier
position with hash h (0 if none), so flag_i = MAP <=> the previous quad
of i's hash group equals quad_i. A sort by (hash, index) makes that
previous quad the adjacent one; a second sort routes the map bits back
to stream order.
"""

from __future__ import annotations

import os

import torch

from density_tpu_torch.constants import CHAMELEON as SPEC
from density_tpu_torch.constants import HASH_MULTIPLIER_I32
from density_tpu_torch.engine import layout
from density_tpu_torch.engine.grouping import (
    hash_quads, prev_valid_value_in_group, shift_right)
from density_tpu_torch.kernels import bigsort, bitonic
from density_tpu_torch.kernels.packroute import signature_words

Q = SPEC.quads_per_block  # 64
SIG_WORDS = SPEC.sig_words  # 4
BLOCK = SPEC.block_size  # 256
BIAS = -2**31  # signed order of k ^ BIAS == unsigned order of k


def classify(quads, hashes, real, copy_blocks):
    """Per-quad tokens given the copy-block hypothesis (S, nb): quads in
    copy blocks neither emit tokens nor touch the dictionary. Returns
    (flags, pw, w0, w1, valid)."""
    valid = real & copy_blocks.repeat_interleave(Q, dim=1).logical_not()
    prev_val, _ = prev_valid_value_in_group(hashes, quads, valid, fill=0)
    is_map = valid & (quads == prev_val)
    flags = is_map.to(torch.int32)
    pw = torch.where(valid, torch.where(is_map, 1, 2), 0).to(torch.int32)
    w0 = torch.where(is_map, hashes, quads & 0xFFFF)
    w1 = (quads >> 16) & 0xFFFF
    return flags, pw, w0, w1, valid


def sig_pack(flags_2d):
    """(..., 64) 1-bit flags, LSB-first -> (..., 4) u16 signature words."""
    return signature_words(flags_2d, Q, SIG_WORDS, 1).squeeze(-2)


def _sort_mod():
    """The planner's sort kernel: `bitonic` under
    DENSITY_TPU_SORT=bitonic, `bigsort` otherwise. Read on every call,
    as the JAX package reads it at trace time (`_sort_mod`)."""
    return (bitonic if os.environ.get("DENSITY_TPU_SORT") == "bitonic"
            else bigsort)


def plan_fast(quads: torch.Tensor, nbytes: torch.Tensor):
    """Copy-free planner for (S, n_q) int32 quads, n_q a power of two:
    the port of `plan_fast_pallas`. Two sorts on the sort kernel of
    `_sort_mod`: forward by (hash, index), back by (index << 1 | map
    bit).

    n_q <= 2**16: (hash << 16 | index) is one biased key, the quad rides
    along. Above: 2 keys, (hash, index high bits) and (index low 16 bits,
    cmp16), where cmp16 -- the low product bits (their LSB is always 0,
    the multiplier being even) with the quad's top bit -- pins the quad
    exactly given its hash. Returns (flags, pw, w0, w1, real, bits).
    """
    sort = _sort_mod().sort
    S, n_q = quads.shape
    dev = quads.device
    quads = quads.to(torch.int32)
    h = hash_quads(quads)
    lidx = torch.arange(n_q, dtype=torch.int32, device=dev)[None, :]
    if n_q <= (1 << 16):
        key = ((h << 16) | lidx) ^ BIAS
        k_s, q_s = sort(key.expand(S, n_q), quads, n_keys=1)
        u_s = k_s ^ BIAS
        h_grp = (u_s >> 16) & 0xFFFF
        lidx_s = u_s & 0xFFFF
        same = shift_right(h_grp, -1) == h_grp
        prev_q = shift_right(q_s, 0)
        # first-in-group sees the zero-initialized dictionary
        is_map_s = torch.where(same, q_s == prev_q, q_s == 0)
    else:
        seg_bits = (n_q - 1).bit_length() - 16
        prod = quads * HASH_MULTIPLIER_I32
        cmp16 = (((prod & 0xFFFF) >> 1)
                 | (((quads >> 31) & 1) << 15))
        p = (h << seg_bits) | (lidx >> 16)
        k2 = (((lidx & 0xFFFF) << 16) | cmp16) ^ BIAS
        p_s, k2_s = sort(p, k2, n_keys=2)
        u = k2_s ^ BIAS
        cmp_s = u & 0xFFFF
        h_grp = p_s >> seg_bits
        same = (shift_right(p_s, -1) >> seg_bits) == h_grp
        lidx_s = (((p_s & ((1 << seg_bits) - 1)) << 16)
                  | ((u >> 16) & 0xFFFF))
        # quad == 0 <=> hash == 0 and fingerprint == 0
        is_map_s = torch.where(same, cmp_s == shift_right(cmp_s, 0),
                               (h_grp == 0) & (cmp_s == 0))
    packed = (lidx_s << 1) | is_map_s.to(torch.int32)
    (up,) = sort(packed, n_keys=1)
    return finish_plan(up, lidx, quads, h, nbytes)


def finish_plan(up, lidx, quads, h, nbytes):
    """Shared plan tail (`_finish_plan_fp`): unsorted (index << 1 | map)
    words -> token arrays + per-block incompressibility bits."""
    S, n_q = quads.shape
    nbytes = nbytes.to(torch.int32)
    real = lidx < (nbytes[:, None] // 4)
    is_map = ((up & 1) == 1) & real
    flags = is_map.to(torch.int32)
    pw = torch.where(real, torch.where(is_map, 1, 2), 0).to(torch.int32)
    w0 = torch.where(is_map, h, quads & 0xFFFF)
    w1 = (quads >> 16) & 0xFFFF
    bits = layout.incompressible_bits(pw, nbytes, Q, SIG_WORDS, BLOCK)
    return flags, pw, w0, w1, real.expand(S, n_q), bits


PIPELINE = layout.Pipeline(name="chameleon", Q=Q, SIG_WORDS=SIG_WORDS,
                           BLOCK=BLOCK, flag_bits=SPEC.flag_bits,
                           plan_fast=plan_fast, classify=classify,
                           sig_pack=sig_pack)


def encode(data, device=None) -> bytes:
    """One-shot single-stream encode; density-compatible bytes."""
    return layout.encode_oneshot(PIPELINE, data, device)


def decode(data: bytes, device=None) -> bytes:
    """One-shot single-stream decode of a density chameleon stream."""
    from density_tpu_torch.parallel import sharding
    return sharding.decode_streams([bytes(data)], None, device)[0]
