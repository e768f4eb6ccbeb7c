"""Encode assembly: the port of the TPU pack kernel.

Counterpart of `density_tpu/kernels/packroute.py::pack`: per-quad
tokens (flags, payload words pw in {0, 1, 2}, w0, w1) and per-stream
byte counts become block streams on a u16 word lattice:

    [signature words][w0 (w1) for each token] per real block,

blocks packed back to back from word 0, padding blocks (index >=
ceil(nbytes / block)) adding nothing, and the 1-3 ragged tail bytes --
stamped by the caller into w0/w1 at the partial quad, whose pw is 0 --
written at Wtot and Wtot + 1 (reference: codec.rs:58-62).

On a CUDA tensor `pack` launches `csrc/packroute.cu` (one launch: a
thread-block cluster per stream); on a CPU tensor it runs `pack_plain`.
Output: (S, out_width) int32 holding u16 values, zero past each
stream's end.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from density_tpu_torch.kernels import _build

GQ = 16384  # quads per routing group of the TPU kernel
MAX_K = 32  # the kernel's most clusters per stream
launches = 0  # kernel launches through `pack` (see chip_smoke.py)
# The kernel's clusters trade their totals through device words tagged
# with the call's epoch: one buffer per (device, CUDA stream), which only
# the kernel writes, and one counter for every device, which never
# repeats an epoch on any buffer (all are dropped when it wraps). Both
# are taken under `_epoch_lock` (`_next_epoch`): two calls that took one
# epoch could read each other's totals, and give wrong bytes.
_tagged: dict = {}
_epoch = 0
_epoch_lock = threading.Lock()
# With K > 1 clusters a stream, a launch's clusters wait for each other,
# which is safe because the launch takes no more clusters than the card
# holds at once. Two such launches running at once on two CUDA streams
# could each hold part of the card and wait for the rest (a trap after
# about a second). So the launches on a device run in the order they were
# made, whatever their streams: each waits for the event recorded after
# the one before it (`_in_device_order`).
_last_launch: dict = {}
_order_lock = threading.Lock()


def out_width(N: int, q: int, sig_words: int) -> int:
    """Words of the output lattice: every quad plain plus one signature
    per block bounds any stream, its ragged tail included."""
    return 2 * N + (N // q) * sig_words


def signature_words(flags: torch.Tensor, q: int, sig_words: int,
                    flag_bits: int) -> torch.Tensor:
    """(..., N) flags -> (..., N / q, sig_words) u16 signature words:
    quad i of a block at bits [i * flag_bits, (i + 1) * flag_bits),
    LSB-first (reference: write_signature.rs:14-17)."""
    lead = flags.shape[:-1]
    f = (flags.to(torch.int64) & ((1 << flag_bits) - 1)).reshape(
        *lead, -1, q)
    shifts = torch.arange(q, device=flags.device) * flag_bits
    sig = (f << shifts).sum(-1)  # bits are disjoint: sum == OR (mod 2**64)
    wsh = torch.arange(sig_words, device=flags.device) * 16
    return ((sig[..., None] >> wsh) & 0xFFFF).to(torch.int32)


def check_args(flags, pw, w0, w1, nbytes, q):
    S, N = flags.shape
    if N % q:
        raise ValueError(f"N={N} is not a multiple of q={q}")
    for a in (pw, w0, w1):
        if a.shape != (S, N) or a.device != flags.device:
            raise ValueError("token arrays differ in shape or device")
    if nbytes.shape != (S,) or nbytes.device != flags.device:
        raise ValueError("nbytes must be (S,) on the tokens' device")


def pack(flags, pw, w0, w1, nbytes, *, q, sig_words, block, flag_bits):
    """Assemble S block streams; see the module docstring. The CUDA
    kernel takes N a multiple of 16384 (the planner's streams of 65536
    bytes and more) and q 16, 32 or 64, and needs pw = 0 past each
    stream's real blocks, as the planner leaves it."""
    check_args(flags, pw, w0, w1, nbytes, q)
    if flags.device.type != "cuda":
        return pack_plain(flags, pw, w0, w1, nbytes, q=q,
                          sig_words=sig_words, block=block,
                          flag_bits=flag_bits)
    S, N = flags.shape
    if N % GQ:
        raise ValueError(f"N={N} is not a multiple of {GQ}")
    ow = out_width(N, q, sig_words)
    args = []
    for a in (flags, pw, w0, w1, nbytes):
        a = a.to(torch.int32).contiguous()
        # the kernel reads rows in 16-byte vectors
        args.append(a.clone() if a.data_ptr() % 16 else a)
    out = torch.empty((S, ow), dtype=torch.int32, device=flags.device)
    epoch, tagged = _next_epoch(
        flags.device, _build.stream_ptr(flags.device).value, S)
    fn = _build.function("packroute", "packroute", 16, tuple(range(7, 15)))
    _in_device_order(flags.device, lambda: _build.launch(
        fn, "packroute", flags.device, *[_build.ptr(a) for a in args],
        _build.ptr(out), _build.ptr(tagged), S, N, q, sig_words, flag_bits,
        block, ow, epoch))
    _build.count_launch(globals())
    return out


def _in_device_order(device, launch) -> None:
    """Runs `launch()`, one kernel launch on the current stream of card
    `device`, after the device's previous packroute launch, whichever
    stream made it (a wait on its event: no host sync)."""
    stream = torch.cuda.current_stream(device)
    with _order_lock:
        prev = _last_launch.get(device.index)
        if prev is not None:
            stream.wait_event(prev)
        launch()
        done = torch.cuda.Event()
        done.record(stream)
        _last_launch[device.index] = done


def _next_epoch(device, stream: int, S: int):
    """A call's epoch, never the same as another call's, and the tagged
    buffer of (device, CUDA stream `stream`), grown to hold S streams'
    words; made on the current stream, which must be `stream`."""
    global _epoch
    with _epoch_lock:
        _epoch = _epoch % (2**31 - 1) + 1
        if _epoch == 1:  # the first call, or the counter wrapped
            _tagged.clear()
        key = (device.index, stream)
        tagged = _tagged.get(key)
        if tagged is None or tagged.numel() < MAX_K * S:
            # zeros carry epoch 0, which no call uses
            tagged = _tagged[key] = torch.zeros(
                MAX_K * max(S, 64), dtype=torch.int64, device=device)
        return _epoch, tagged


def pack_plain(flags, pw, w0, w1, nbytes, *, q, sig_words, block,
               flag_bits):
    """The kernel's arithmetic in plain PyTorch (scatters by index)."""
    check_args(flags, pw, w0, w1, nbytes, q)
    S, N = flags.shape
    dev = flags.device
    nb = N // q
    ow = out_width(N, q, sig_words)
    pw = pw.to(torch.int64)
    nbytes = nbytes.to(torch.int64)
    pwb = pw.reshape(S, nb, q)
    nbr = (nbytes + block - 1) // block
    real_blk = torch.arange(nb, device=dev)[None, :] < nbr[:, None]
    blk_words = torch.where(real_blk, pwb.sum(2) + sig_words, 0)
    blk_off = torch.cumsum(blk_words, 1) - blk_words
    intra = torch.cumsum(pwb, 2) - pwb
    dest = (blk_off[:, :, None] + sig_words + intra).reshape(S, N)
    row = torch.arange(S, device=dev)[:, None] * ow

    out = torch.zeros(S * ow, dtype=torch.int32, device=dev)

    def put(idx, vals, mask):
        mask = mask & (idx >= 0) & (idx < ow)
        out[(row + idx)[mask]] = vals.to(torch.int32)[mask] & 0xFFFF

    sig = signature_words(flags, q, sig_words, flag_bits)
    sdest = blk_off[:, :, None] + torch.arange(sig_words, device=dev)
    put(sdest.reshape(S, -1), sig.reshape(S, -1),
        real_blk[:, :, None].expand(S, nb, sig_words).reshape(S, -1))
    put(dest, w0, pw >= 1)
    put(dest + 1, w1, pw == 2)

    # ragged tail after the final block's payload
    wtot = (pw.sum(1) + nbr * sig_words)[:, None]
    fq = torch.clamp(nbytes // 4, max=N - 1)[:, None]
    rag = (nbytes % 4)[:, None]
    put(wtot, torch.gather(w0, 1, fq), rag > 0)
    put(wtot + 1, torch.gather(w1, 1, fq), rag > 2)
    return out.reshape(S, ow)


def check_route_invariants(flags, pw, nbytes, *, q, sig_words, block,
                           flag_bits):
    """Host check of the TPU pack kernel's routing preconditions: per
    (stream, 16384-quad group), token destinations strictly increase
    over live tokens and are non-negative relative to the group base.
    A copy of `density_tpu/kernels/packroute.py::check_route_invariants`
    for tests; the CUDA kernel stores by address and needs none of it."""
    pwn = np.asarray(pw)
    nbn = np.asarray(nbytes)
    S, N = pwn.shape
    nb = N // q
    n_groups = N // GQ
    nbg = GQ // q
    pwb = pwn.reshape(S, nb, q)
    blk_pay = pwb.sum(axis=2)
    nbr = (nbn + block - 1) // block
    real_blk = np.arange(nb)[None, :] < nbr[:, None]
    blk_words = np.where(real_blk, blk_pay + sig_words, 0)
    blk_off = np.cumsum(blk_words, axis=1) - blk_words
    intra = np.cumsum(pwb, axis=2) - pwb
    dest = (blk_off[:, :, None] + sig_words + intra).reshape(S, N)
    dest = dest - np.repeat(blk_off[:, ::nbg], GQ, axis=1)
    live = pwn >= 1
    for s in range(S):
        for g in range(n_groups):
            sl = slice(g * GQ, (g + 1) * GQ)
            d = dest[s, sl][live[s, sl]]
            if d.size and (np.any(np.diff(d) <= 0) or d[0] < 0):
                return False
    return True
