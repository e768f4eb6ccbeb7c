"""Decode token extraction: the port of the TPU unpack kernel.

Counterpart of `density_tpu/kernels/unpack.py::unpack` (with its
`flags_from_sig` and `flag_payload_words` stages folded in): compressed
block streams become per-quad (flags, w0, w1) lattices.

  * live block (woff >= 0, not copy): flags from its signature words,
    w0 = words[woff + sig_words + intra], w1 = the next word (intra =
    payload words of the block's earlier quads; the reference's token
    sizes are plain 2, map 1, predicted 0 words -- chameleon.rs:18-22,
    cheetah.rs:19-21, lion.rs:19-25);
  * copy block: flags 0, w0/w1 = its raw halfword pairs;
  * dead block (woff < 0): zeros.

w1 of a 1-word token is the word after its payload; only 2-word tokens
read it. Every read is bounds-checked against W (a word past W reads
0); a live block that starts outside the words is malformed: its
outputs are zeros and the error flag is set.

`unpack` raises DecodeError on that flag at once (on the card this reads
the flag back, a host sync). `unpack_flagged` returns the flag as a
one-element device tensor instead, for a caller that reads it later in
the same host copy as its other results. On a CUDA tensor both launch
`csrc/unpack.cu`; on a CPU tensor they run the plain version.
"""

from __future__ import annotations

import torch

from density_tpu_torch.errors import DecodeError
from density_tpu_torch.kernels import _build

launches = 0  # kernel launches of both entry points (see chip_smoke.py)


def flag_payload_words(flags: torch.Tensor, flag_bits: int):
    """flag -> payload halfwords: plain(0) -> 2, map -> 1, predicted -> 0."""
    if flag_bits == 1:
        return torch.where(flags == 0, 2, 1)
    if flag_bits == 2:
        return torch.where(flags == 0, 2, torch.where(flags == 3, 0, 1))
    return torch.where(flags == 0, 2, torch.where(flags >= 6, 1, 0))


def _check_args(words, woff, is_copy, q, sig_words, flag_bits):
    S, _ = words.shape
    if woff.ndim != 2 or woff.shape[0] != S or woff.device != words.device:
        raise ValueError("woff must be (S, NB) on the words' device")
    if is_copy is not None and (is_copy.shape != woff.shape
                                or is_copy.device != words.device):
        raise ValueError("is_copy must match woff")
    if flag_bits not in (1, 2, 3) or not 1 <= sig_words <= 4 or (
            q * flag_bits > 16 * sig_words):
        raise ValueError(f"bad geometry q={q} sig_words={sig_words} "
                         f"flag_bits={flag_bits}")


def malformed() -> DecodeError:
    return DecodeError("malformed block offset: a live block starts "
                       "outside the compressed words")


def unpack(words, woff, is_copy=None, *, q, sig_words, flag_bits):
    """Returns (flags, w0, w1), each (S, NB * q) int32; raises
    DecodeError if a live block is malformed.

    words: (S, W) u16 values (any integer dtype); woff: (S, NB) int32
    block word offsets, < 0 for dead blocks; is_copy: (S, NB) bool or
    None."""
    _check_args(words, woff, is_copy, q, sig_words, flag_bits)
    if words.device.type != "cuda":
        return unpack_plain(words, woff, is_copy, q=q, sig_words=sig_words,
                            flag_bits=flag_bits)
    flags, w0, w1, bad = _launch(words, woff, is_copy, q, sig_words,
                                 flag_bits)
    if int(bad.item()) != 0:
        raise malformed()
    return flags, w0, w1


def unpack_flagged(words, woff, is_copy=None, *, q, sig_words, flag_bits):
    """As `unpack`, but returns (flags, w0, w1, bad) and never reads the
    device: bad is a one-element int32 tensor, nonzero where a live block
    was malformed (its outputs are then zeros)."""
    _check_args(words, woff, is_copy, q, sig_words, flag_bits)
    if words.device.type != "cuda":
        return _plain(words, woff, is_copy, q, sig_words, flag_bits)
    return _launch(words, woff, is_copy, q, sig_words, flag_bits)


def _launch(words, woff, is_copy, q, sig_words, flag_bits):
    global launches
    S, W = words.shape
    NB = woff.shape[1]
    dev = words.device
    wd = words.to(torch.int32).contiguous()
    wo = woff.to(torch.int32).contiguous()
    cp = None
    if is_copy is not None:  # bool is a byte of 0 or 1: reinterpreted
        cp = is_copy.contiguous()
        cp = cp.view(torch.uint8) if cp.dtype == torch.bool else cp.to(
            torch.uint8)
    outs = torch.empty((3, S, NB * q), dtype=torch.int32, device=dev)
    bad = torch.empty(1, dtype=torch.int32, device=dev)
    fn = _build.function("unpack", "unpack", 14, tuple(range(7, 13)))
    _build.launch(fn, "unpack", dev, _build.ptr(wd), _build.ptr(wo),
                  _build.ptr(cp), _build.ptr(outs[0]), _build.ptr(outs[1]),
                  _build.ptr(outs[2]), _build.ptr(bad), S, NB, W, q,
                  sig_words, flag_bits)
    launches += 1
    return outs[0], outs[1], outs[2], bad


def unpack_plain(words, woff, is_copy=None, *, q, sig_words, flag_bits):
    """The kernel's arithmetic in plain PyTorch (bounds-checked gathers);
    raises DecodeError if a live block is malformed."""
    _check_args(words, woff, is_copy, q, sig_words, flag_bits)
    flags, w0, w1, bad = _plain(words, woff, is_copy, q, sig_words,
                                flag_bits)
    if int(bad.item()) != 0:
        raise malformed()
    return flags, w0, w1


def _plain(words, woff, is_copy, q, sig_words, flag_bits):
    """(flags, w0, w1, bad): a malformed live block gives zeros, as a
    dead one does, and sets bad."""
    S, W = words.shape
    NB = woff.shape[1]
    dev = words.device
    words = words.to(torch.int64)
    woff = woff.to(torch.int64)
    cp = (torch.zeros_like(woff, dtype=torch.bool) if is_copy is None
          else is_copy.to(torch.bool))
    bad = (woff >= 0) & ((woff >= W) | (~cp & (woff > W - sig_words)))
    woff = torch.where(bad, -1, woff)
    dead = woff < 0

    def rd(pos):
        ok = (pos >= 0) & (pos < W)
        return torch.where(ok, torch.gather(words, 1, pos.clamp(0, W - 1)),
                           0) & 0xFFFF

    # signature -> flags (quad i at bits [i*flag_bits, (i+1)*flag_bits))
    sidx = woff[:, :, None] + torch.arange(sig_words, device=dev)
    sw = rd(sidx.reshape(S, -1)).reshape(S, NB, sig_words)
    sig = (sw << (16 * torch.arange(sig_words, device=dev))).sum(-1)
    shifts = torch.arange(q, device=dev) * flag_bits
    flags = (sig[:, :, None] >> shifts) & ((1 << flag_bits) - 1)
    pw = flag_payload_words(flags, flag_bits)
    intra = torch.cumsum(pw, 2) - pw
    pos = woff[:, :, None] + sig_words + intra
    live = (pw >= 1).reshape(S, -1)
    w0 = torch.where(live, rd(pos.reshape(S, -1)), 0)
    w1 = torch.where(live, rd(pos.reshape(S, -1) + 1), 0)

    # copy blocks: raw halfword pairs; dead blocks: zeros
    craw = woff[:, :, None] + 2 * torch.arange(q, device=dev)
    cq = cp[:, :, None].expand(S, NB, q).reshape(S, -1)
    w0 = torch.where(cq, rd(craw.reshape(S, -1)), w0)
    w1 = torch.where(cq, rd(craw.reshape(S, -1) + 1), w1)
    flags = torch.where(cq, 0, flags.reshape(S, -1))
    dq = dead[:, :, None].expand(S, NB, q).reshape(S, -1)
    flags, w0, w1 = (torch.where(dq, 0, x).to(torch.int32)
                     for x in (flags, w0, w1))
    bad_any = bad.any().to(torch.int32).reshape(1)
    return flags, w0, w1, bad_any
