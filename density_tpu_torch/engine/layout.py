"""Block-stream layout engine (encode side) on tensors.

Counterpart of the JAX package's `engine/layout.py`, for any codec's
`Pipeline` (chameleon's and cheetah's geometry):

  * `fused`: the copy-free plan, the ragged-tail stamp, the pack kernel,
    the stream totals and the no-copy certificate in one pass
    (`fused_pallas_batched`);
  * `run_encode`: that pass, and when a stream's certificate fails, the
    host-driven fixed point over the copy-block set with the masked
    plan and the masked (with-copy) assembly (`run_encode`,
    `assemble_one`).

Quads are (S, n_q) int32 bit patterns of the little-endian input;
n_q is a power of two >= 4096 (`stage_quads` pads to it), so every
stream goes through the sort and pack kernels. Padding quads are zero,
lie past nbytes // 4 and carry the largest indices, so they change no
output word.

The pack kernel is chosen as the JAX package chooses it
(`fused_pallas_batched`): `packroute` where n_q is a multiple of 16384
and the pack mode is "route", `pack` otherwise (4096- and 8192-quad
streams, and every size in mode "onehot"). The mode comes from
`DENSITY_TPU_PACK` once, at import, as in the JAX package; `PACK_MODE`
is the module attribute that holds it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from density_tpu_torch.engine.grouping import hash_quads
from density_tpu_torch.engine.protection import replay_fsm
from density_tpu_torch.kernels import pack, packroute

# Plans of the fixed point over the copy-block set before the batch goes
# to the native encoder. Its fixed point is unique (a block's copy
# decision depends only on earlier blocks), so a higher cap changes no
# byte, only where the bytes are made. The JAX package stops at 8; lion
# text can need more (9 for the first 64 KiB of the stdlib's source),
# and 8 would leave such batches to the host.
MAX_FIXED_POINT_ITERS = 16
MIN_QUADS = pack.GQ_MIN  # one tile of the small-stream pack kernel
PACK_MODE = os.environ.get("DENSITY_TPU_PACK", "route")


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """One codec's encode stages."""

    name: str
    Q: int
    SIG_WORDS: int
    BLOCK: int
    flag_bits: int
    plan_fast: Callable  # (quads, nbytes) -> flags, pw, w0, w1, real, bits
    classify: Callable   # (quads, hashes, real, copy) -> flags, pw, w0, w1, valid
    sig_pack: Callable   # (..., Q) flags -> (..., SIG_WORDS) words


def incompressible_bits(pw, nbytes, Q, SIG_WORDS, BLOCK):
    """Per-block 'incompressible' bits (reference: codec.rs:68): encoded
    size, signature and ragged tail included, >= the block size."""
    S, n_q = pw.shape
    nb = n_q // Q
    pbw = pw.reshape(S, nb, Q).sum(2)
    bidx = torch.arange(nb, device=pw.device)[None, :]
    nbr = ((nbytes + BLOCK - 1) // BLOCK)[:, None]
    enc = (2 * SIG_WORDS + 2 * pbw
           + torch.where(bidx == nbr - 1, (nbytes % 4)[:, None], 0))
    return enc >= BLOCK


def stamp_ragged(quads, nbytes, w0, w1):
    """The pack kernel places the ragged tail from w0/w1 at the partial
    quad, but the plan may hold a hash there: stamp the raw input
    halfwords (reference: codec.rs:58-62 pushes the remainder verbatim).
    Returns new (w0, w1)."""
    S, n_q = quads.shape
    rows = torch.arange(S, device=quads.device)
    fq = torch.clamp(nbytes // 4, max=n_q - 1).long()
    ragged = nbytes % 4 > 0
    rq = quads[rows, fq]
    w0 = w0.clone()
    w1 = w1.clone()
    w0[rows, fq] = torch.where(ragged, rq & 0xFFFF, w0[rows, fq])
    w1[rows, fq] = torch.where(ragged, (rq >> 16) & 0xFFFF, w1[rows, fq])
    return w0, w1


def pack_module(n_q: int):
    """The pack kernel's module for n_q quads per stream."""
    if PACK_MODE == "route" and n_q % packroute.GQ == 0:
        return packroute
    return pack


def fused(pipe: Pipeline, quads, nbytes):
    """Copy-free plan + pack assembly + totals + the no-copy certificate.

    The protection FSM arms a copy penalty only after TWO consecutive
    incompressible blocks, so where no two adjacent blocks are
    incompressible the FSM never leaves the encode path: `ok` reports
    that. Returns (out_words, totals, ok, plan)."""
    flags, pw, w0, w1, real, bits = pipe.plan_fast(quads, nbytes)
    ok = ~torch.any(bits[:, 1:] & bits[:, :-1], dim=1)
    w0, w1 = stamp_ragged(quads, nbytes, w0, w1)
    out = pack_module(quads.shape[1]).pack(
        flags, pw, w0, w1, nbytes, q=pipe.Q, sig_words=pipe.SIG_WORDS,
        block=pipe.BLOCK, flag_bits=pipe.flag_bits)
    nbr = (nbytes + pipe.BLOCK - 1) // pipe.BLOCK
    totals = (2 * pw.sum(1) + nbr * 2 * pipe.SIG_WORDS
              + nbytes % 4).to(torch.int32)
    return out, totals, ok, (flags, pw, w0, w1, real, bits)


def plan_masked(pipe: Pipeline, quads, nbytes, copy):
    """General plan under a copy-block hypothesis (S, nb)."""
    n_q = quads.shape[1]
    real = (torch.arange(n_q, device=quads.device)[None, :]
            < (nbytes // 4)[:, None])
    flags, pw, w0, w1, valid = pipe.classify(quads, hash_quads(quads),
                                             real, copy)
    bits = incompressible_bits(pw, nbytes, pipe.Q, pipe.SIG_WORDS,
                               pipe.BLOCK)
    return flags, pw, w0, w1, valid, bits


def step_fsm(bits, nbytes, BLOCK):
    """Copy decisions of the protection FSM (host), real blocks only."""
    bits_np = bits.cpu().numpy()
    nbr = (nbytes.cpu().numpy().astype(np.int64) + BLOCK - 1) // BLOCK
    nb = bits_np.shape[1]
    return replay_fsm(bits_np) & (np.arange(nb)[None, :] < nbr[:, None])


def assemble_masked(pipe: Pipeline, quads, nbytes, copy, flags, pw, w0, w1,
                    valid):
    """With-copy assembly by scatters (`assemble_one`): [signature]
    [tokens][ragged tail] per encoded block, the raw input words for a
    copy block. Returns ((S, out_width) int32 words, (S,) totals)."""
    Q, SW, BLOCK = pipe.Q, pipe.SIG_WORDS, pipe.BLOCK
    S, n_q = quads.shape
    dev = quads.device
    nb = n_q // Q
    nbytes = nbytes.to(torch.int64)
    bidx = torch.arange(nb, device=dev)[None, :]
    ragged = (nbytes % 4)[:, None]
    nbr = ((nbytes + BLOCK - 1) // BLOCK)[:, None]
    last_real = nbr - 1
    pwl = pw.to(torch.int64)
    enc_bytes = (2 * SW + 2 * pwl.reshape(S, nb, Q).sum(2)
                 + torch.where(bidx == last_real, ragged, 0))
    is_real = bidx < nbr
    blen = torch.clamp(nbytes[:, None] - bidx * BLOCK, 0, BLOCK)
    out_bytes = torch.where(is_real, torch.where(copy, blen, enc_bytes), 0)
    word_off = (torch.cumsum(out_bytes, 1) - out_bytes) // 2
    totals = out_bytes.sum(1).to(torch.int32)

    ow = packroute.out_width(n_q, Q, SW)
    out = torch.zeros(S * ow, dtype=torch.int32, device=dev)
    row = torch.arange(S, device=dev)[:, None] * ow

    def put(idx, vals, mask):
        mask = mask & (idx < ow)
        out[(row + idx)[mask]] = vals.to(torch.int32)[mask]

    sig = pipe.sig_pack(flags.reshape(S, nb, Q))
    sidx = word_off[:, :, None] + torch.arange(SW, device=dev)
    smask = (is_real & ~copy)[:, :, None].expand(S, nb, SW)
    put(sidx.reshape(S, -1), sig.reshape(S, -1), smask.reshape(S, -1))

    pwb = pwl.reshape(S, nb, Q)
    pos = (word_off[:, :, None] + SW + torch.cumsum(pwb, 2) - pwb
           ).reshape(S, n_q)
    put(pos, w0, valid & (pwl >= 1))
    put(pos + 1, w1, valid & (pwl == 2))

    # ragged tail: raw input halfwords after the final block's payload
    lr = torch.clamp(last_real, 0, nb - 1)
    last_is_copy = torch.gather(copy, 1, lr)
    fq = torch.clamp(nbytes // 4, max=n_q - 1)[:, None]
    rq = torch.gather(quads, 1, fq)
    rag_pos = (torch.gather(word_off, 1, lr)
               + (torch.gather(enc_bytes, 1, lr) - ragged) // 2)
    rag_ok = ~last_is_copy & (nbr > 0)
    put(rag_pos, rq & 0xFFFF, rag_ok & (ragged > 0))
    put(rag_pos + 1, (rq >> 16) & 0xFFFF, rag_ok & (ragged > 2))

    # copy blocks: the raw input words (word j = half j & 1 of quad j//2)
    wpb = BLOCK // 2
    j = torch.arange(wpb, device=dev)
    src = (bidx[:, :, None] * wpb + j).reshape(1, -1).expand(S, -1)
    src_q = torch.gather(quads, 1, torch.clamp(src // 2, max=n_q - 1))
    src_w = torch.where(src % 2 == 0, src_q & 0xFFFF, (src_q >> 16) & 0xFFFF)
    dst = (word_off[:, :, None] + j).reshape(S, -1)
    cmask = ((copy & is_real)[:, :, None]
             & (j < ((blen + 1) // 2)[:, :, None])).reshape(S, -1)
    put(dst, src_w, cmask)
    return out.reshape(S, ow), totals


def run_encode(pipe: Pipeline, quads, nbytes):
    """Encode (S, n_q) staged quads. The fused copy-free pass is the
    whole job when every stream's certificate holds; otherwise the
    host-driven fixed point over the copy-block set decides the copies.
    Returns (out_words, totals, converged)."""
    out, totals, ok, plan = fused(pipe, quads, nbytes)
    ok = ok.cpu().numpy()
    if ok.all():
        return out, totals, True
    # A stream whose certificate holds has no copy block, so the fixed
    # point runs on the failing streams alone.
    fail = torch.from_numpy(np.flatnonzero(~ok)).to(quads.device)
    quads, nbytes = quads[fail], nbytes[fail]
    flags, pw, w0, w1, valid, bits = (x[fail] for x in plan)
    copy = np.zeros((len(fail), quads.shape[1] // pipe.Q), bool)
    converged = False
    for it in range(MAX_FIXED_POINT_ITERS):
        if it > 0:
            flags, pw, w0, w1, valid, bits = plan_masked(
                pipe, quads, nbytes, torch.from_numpy(copy).to(quads.device))
        new_copy = step_fsm(bits, nbytes, pipe.BLOCK)
        if np.array_equal(new_copy, copy):
            converged = True
            break
        copy = new_copy
    if converged and not copy.any():
        return out, totals, True  # the copy-free pass was already right
    sub_out, sub_totals = assemble_masked(
        pipe, quads, nbytes, torch.from_numpy(copy).to(quads.device),
        flags, pw, w0, w1, valid)
    out[fail] = sub_out
    totals[fail] = sub_totals
    return out, totals, converged


def pad_quads(n_q: int) -> int:
    """The device quad capacity: a power of two >= MIN_QUADS."""
    return max(MIN_QUADS, 1 << max(0, n_q - 1).bit_length())


def stage_quads(padded_u8: np.ndarray, device) -> torch.Tensor:
    """(S, cap_bytes) zero-padded input bytes -> (S, pad_quads) int32
    quads on `device` (a little-endian view, zero-extended)."""
    S, cap = padded_u8.shape
    n_q = pad_quads(cap // 4)
    quads = np.zeros((S, n_q), np.int32)
    quads[:, :cap // 4] = padded_u8.view("<i4")
    return torch.from_numpy(quads).to(device)


def encode_oneshot(pipe: Pipeline, data, device=None) -> bytes:
    """Single-stream wrapper: bytes in, density-stream bytes out."""
    from density_tpu_torch import native
    from density_tpu_torch.parallel.mesh import resolve_device
    dev = resolve_device(device)
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    n = buf.size
    if n == 0:
        return b""
    padded = np.zeros((1, bucket_bytes(n, pipe.BLOCK)), np.uint8)
    padded[0, :n] = buf
    nbytes = torch.tensor([n], dtype=torch.int32, device=dev)
    out, totals, converged = run_encode(pipe, stage_quads(padded, dev),
                                        nbytes)
    if not converged:  # pathological stream: the exact host encoder
        return native.encode(pipe.name, buf.tobytes())
    total = int(totals[0])
    words = out[0, :(total + 1) // 2].cpu().numpy().astype("<u2")
    return words.tobytes()[:total]


def bucket_bytes(n: int, block: int) -> int:
    """Round capacity up to a coarse bucket (<= 12.5% padding): next
    multiple of pow2/8, min one block, multiple of the block size."""
    n = max(n, block)
    n = -(-n // block) * block
    p = 1 << (n - 1).bit_length()
    step = max(p // 8, block)
    step = -(-step // block) * block
    return -(-n // step) * step
