#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`density_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--out DIR] [--seed N] [--parent DIR]

Needs one CUDA card, `nvcc` and `g++`; imports no JAX. Phases:
  (a) build the seven CUDA kernels from `density_tpu_torch/csrc/` and the
      native host runtime from `density_tpu_torch/native/`;
  (b) hold each kernel against its plain PyTorch version on the card,
      bit for bit, at the shapes of the paths below (and a
      malformed-offset case that must raise DecodeError); packroute also
      at the three geometries at 16384-2^23 quads, unpack at flag_bits
      1-3 with copy, dead and malformed blocks; bigsort also
      on tie-heavy keys at rows of 2^15-2^17, whose merges take global
      launches of 1-4 bits; bitonic also at rows of one CTA, one
      cluster and longer (2^12-2^18, tie-heavy), and equal to bigsort;
      and all four of cheetah's kernels at its shapes: the resolve's and
      the planner's 3-array 2-key sorts (S=38 x 65536, one 2^22-quad
      row), the planner's packed sorts, packroute and pack at q=32,
      flag_bits=2; and the same four at lion's shapes (its resolve's
      sort keys, packroute and pack at q=16, flag_bits=3); the MTF-5 scan
      on the operands lion's copy-free plan hands it (S=38 x 65536, the
      tail's S=1 x 65536, the corpus as one 2^22-quad row); the
      protection FSM's step, copy set and flags, on the incompressible
      bits of lion's and cheetah's copy-free plans (S=38 x 4096 and
      2048 blocks) and lion's tail (S=1 x 4096);
  (c) the main path: chameleon compress and decompress on the card of a
      10,192,446-byte text corpus in 256 KiB streams, with every
      kernel's launch count read around it; stream bytes held against
      the port's CPU path and its scalar encoder, and the golden vector;
  (d) incompressible and mixed inputs (fixed point, copy blocks, ragged
      lengths);
  (e) the launch counts: bigsort, packroute and unpack from (c), pack
      from (g), bitonic from (h), the MTF-5 scan from (p): one launch a
      plan of lion's (copy-free and masked), none in chameleon's and
      cheetah's compress; the FSM step from (p): one launch a pass of
      the fixed point, in every codec's compress;
  (f) timings: device-resident encode and decode with CUDA events, at
      256 KiB, 32 KiB and 16 KiB streams; the device time of each
      kernel, its plain version and the library call beside it, from
      torch.profiler (bigsort and bitonic at every shape the paths sort,
      with the kernel launches per sort that the trace counts; bitonic
      with bigsort's time beside it and the clusters the card holds at
      once, and on one 32 MiB stream; packroute and unpack with their
      kernel launches per call); one profiler trace each of encode and
      decode at 256 KiB and 32 KiB; the host syncs of one decode; the
      encode with the default sort and under DENSITY_TPU_SORT=bitonic,
      in turns; the 3-array 2-key sorts of (b) against `torch.sort` of
      the packed int64 keys and a gather; cheetah's device-resident
      encode (corpus, 256 KiB) and decode (phase l's input), the host
      pool's decode of the corpus, their host syncs and traces; the same
      for lion (its decode on phase q's input), and packroute (S=38 x
      65536) and pack (S=622 x 4096) on lion's plans; the MTF-5 scan at
      (b)'s three shapes, beside its bound and its plain version (no
      library call computes it); the FSM step at (b)'s three shapes,
      beside its bound (bytes once) and the host time of the plain
      replay;
  (g) small streams: the corpus in 32 KiB and 16 KiB streams (4096- and
      8192-quad shapes, the pack kernel), compress and decompress on the
      card with launch counts, three streams of each held against the
      CPU path;
  (h) the options: DENSITY_TPU_SORT=bitonic (the planner on the bitonic
      kernel) at 256 KiB and 32 KiB streams, and pack mode "onehot" at
      256 KiB, each byte-identical to the default containers;
  (i) the one-shot API: `encode_raw`/`decode_raw` on the card against
      the scalar backend and the CPU path;
  (j) large streams: the corpus in 1 MiB streams (2^18 quads) and in
      the default 32 MiB stream (one stream of 2^22 quads), compress
      and decompress on the card with launch counts, held against the
      CPU path on a stream or a 2 MiB prefix;
  (k) cheetah's main path: the corpus in 256 KiB streams compressed on
      the card with launch counts, every stream against the native
      encoder and three against the CPU path; decompress by its route
      (the predicted share is printed);
  (l) cheetah's device decode where the fixpoint converges: 38 x 256
      KiB of quads drawn from 1024 values made from `--seed`, decoded
      on the card with every stream converged;
  (m) the device decode of the corpus's streams at 12 rounds (how many
      converge), then three streams with the cap raised until they do;
  (n) cheetah in 16 KiB streams (pack) and the default 32 MiB stream
      (the planner's 3-array sorts), against the native encoder, round
      trip, byte-identical under DENSITY_TPU_SORT=bitonic;
  (o) cheetah on random and mixed inputs (fixed point, copy blocks,
      ragged lengths) decoded on both routes, and one-shot streams;
  (p) lion's main path: the corpus in 256 KiB streams compressed on the
      card with launch counts, every stream against the native encoder
      and three against the CPU path; decompress by its route (the
      predicted share is printed);
  (q) lion's device decode of phase l's kind of input (38 x 256 KiB of
      quads from 1024 values made from `--seed`), every stream
      converged; and how many of the corpus's streams converge at 12
      rounds;
  (r) lion in 16 KiB streams (pack) and the default 32 MiB stream (the
      planner's 3-array sorts), against the native encoder, round trip,
      byte-identical under DENSITY_TPU_SORT=bitonic and pack mode
      "onehot";
  (s) lion on random and mixed inputs decoded on both routes, and
      one-shot streams;
  (t) shares on the card, run at once (a worker thread and a CUDA
      stream each): the corpus in 256 KiB streams in 2 and 4 shares on
      the card (and over every card where there are several) for the
      three codecs, 10 round trips each: every container equal to (c)'s,
      (k)'s or (p)'s, decompress through the shares (cheetah and lion
      also on the device route, on (l)'s and (q)'s input), every kernel
      of the path launched at least once per share; chameleon in 2
      shares in 16 KiB streams (pack) and under DENSITY_TPU_SORT=bitonic,
      and in 4 shares of 1 MiB streams (packroute's several clusters a
      stream, launched from several streams);
      the share of each call's wall in which two or more share tasks
      were in flight (above 0 for every 2-share compress; the tasks'
      `density.sharding.share` spans in a profiler session around 10
      more round trips, each checked too); host syncs and
      launches per call on one device (with `--parent DIR`, equal to that
      tree's) and in shares, where no worker may wait for the card while
      it holds the host's turn (`density_tpu_torch/hostsync.py`);
      compress and decompress timed on one device and in 2 and 4 shares,
      in turns (`tools/share_costs.py` takes these walls apart);
  (u) two `torch.distributed` ranks (gloo, torchrun's environment, both
      on `cuda:0` with one card) compress and decompress the corpus, (l)'s
      seeded input and the JAX package's 97-value multi-chip input for
      the three codecs; every rank's container equals one process's;
  (v) `encode_stats` on the card for the three codecs, on one 256 KiB
      stream and on the corpus as one 2^22-quad stream, equal to
      `stream_stats` of the card's encoded stream, bigsort counted, timed
      beside one planner pass;
  (w) chunked sessions (`StreamEncoder`/`StreamDecoder`) of the corpus in
      uneven chunks, equal to `native.encode`, and an LZ4 round trip;
  (x) the fault surface, in a child process killed after FAULT_TIMEOUT
      (a kernel that hangs fails the phase): headers of no streams raise
      DecodeError on the card for the three codecs; about 30 seeded
      mutations (`mutations`: header fields, stream table, payload,
      cuts, appended bytes, swapped streams) of 8 containers a codec
      (`fault_input`: three 4 KiB streams and a tail, compressed on the
      card, equal to `native.encode`) give on the card the outcome
      (DecodeError or bytes) and the bytes of the CPU path, cheetah and
      lion also on the device route; the seven adversarial FSM inputs
      of the JAX package's fuzz suite encode with each codec on the card
      to `native.encode`'s bytes under both sort options; the golden
      vectors both ways; all seven kernels launched in the phase.
Phase (t) runs last, after (e) and (f), whose profiler sessions came
back with no device event in most runs that had run (t) before them.
Prints the card's name and power limit, a `kernels` JSON line and, last,
the device JSON line. Any failure exits non-zero. Writes the compiler's
register report to `DIR/ptxas.txt` and the profiles to
`DIR/profile_*.txt` (DIR: `--out`, by default `smoke_out`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import statistics
import struct
import subprocess
import sys
import time

import numpy as np

STREAM = 256 << 10  # bytes per stream of the device grain
SMALL_STREAMS = (32 << 10, 16 << 10)  # 8192- and 4096-quad streams
LARGE_STREAMS = (1 << 20, 32 << 20)  # 2^18 quads; the library default
CORPUS_SIZE = 10_192_446
REPEATS = 5  # timing windows of the device-resident encode and decode
OUT_DIR = "smoke_out"  # reports too long for the standard output
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
ALU_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit rate (data sheet)
TEST_DATA = b"test" * 31 + b"t"
# the reference's own vectors (`tests/test_golden.py`)
GOLDEN = {
    "chameleon": bytes([0xfe, 0xff, 0xff, 0x7f, 0, 0, 0, 0,
                        116, 101, 115, 116] + [112, 251] * 30 + [116]),
    "cheetah": bytes([244, 255, 255, 255, 255, 255, 255, 63,
                      116, 101, 115, 116, 112, 251, 116]),
    "lion": bytes([112, 146, 36, 73, 146, 36, 116, 101, 115, 116, 112, 251,
                   73, 146, 36, 73, 146, 4, 116]),
}
REPLACES = {
    "bigsort": "density_tpu/kernels/bigsort.py:166",
    "packroute": "density_tpu/kernels/packroute.py:161",
    "unpack": "density_tpu/kernels/unpack.py:379",
    "pack": "density_tpu/kernels/pack.py:279",
    "bitonic": "density_tpu/kernels/bitonic.py:121",
    # no Pallas kernel: the JAX package's jax.lax.associative_scan
    "mtf": "density_tpu/engine/mtf.py:54",
    # the same scan at K=2: the JAX package's MTF-2 associative_scan
    "mtf2": "density_tpu/engine/grouping.py:181",
    # no Pallas kernel: the JAX package's jax.lax.scan
    "fsm": "density_tpu/engine/protection.py:32",
}
SOURCE = {"mtf2": "mtf"}  # a row's kernel source where it is not its name
CHAM = dict(q=64, sig_words=4, block=256, flag_bits=1)
CHEE = dict(q=32, sig_words=4, block=128, flag_bits=2)
LION = dict(q=16, sig_words=3, block=64, flag_bits=3)


def log(*a):
    print(*a, flush=True)


def corpus_bytes(target: int = CORPUS_SIZE) -> bytes:
    """Concatenated Python-stdlib source text, walked in sorted order (the
    JAX package's bench corpus, rebuilt here without its cache)."""
    root = os.path.dirname(os.__file__)
    parts, size = [], 0
    for dirpath, dirnames, filenames in sorted(os.walk(root),
                                               key=lambda t: t[0]):
        dirnames.sort()
        if "site-packages" in dirpath or "__pycache__" in dirpath:
            continue
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            try:
                with open(os.path.join(dirpath, fn), "rb") as f:
                    parts.append(f.read())
            except OSError:
                continue
            size += len(parts[-1])
            if size >= target:
                break
        if size >= target:
            break
    blob = b"".join(parts)[:target]
    if len(blob) < target:
        blob = (blob * (target // max(1, len(blob)) + 1))[:target]
    return blob


def payloads(blob: bytes) -> list[bytes]:
    from density_tpu_torch.container import parse_header
    _, _, _, lengths, off = parse_header(blob)
    ends = off + np.cumsum(lengths)
    return [blob[e - l:e] for e, l in zip(ends, lengths)]


def max_abs_err(a, b) -> int:
    import torch
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def timed_ms(fn, iters: int = 10) -> float:
    """Mean milliseconds per call on the card (CUDA events, warm)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_work(e) -> bool:
    """Whether a `key_averages()` row is the card's own work (a kernel,
    copy or memset), not a host row nor one of the port's spans drawn on
    the card's timeline (`density_tpu_torch.tracing`)."""
    from torch.autograd import DeviceType
    from density_tpu_torch.tracing import PREFIX
    return e.device_type != DeviceType.CPU and not e.key.startswith(PREFIX)


def device_profile(fn, iters: int = 10) -> tuple[float, float]:
    """Mean device time per call and kernel launches per call: the card's
    own events (kernels, copies, memsets) under torch.profiler, their
    times summed, so that the host's launch gaps, which vary from machine
    to machine, are left out; the launches count the kernels alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the profiler now and then records no device event at all in a
    # session (seen on the H100 after many sessions): profile again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if device_work(e)]
        us = sum(e.self_device_time_total for e in events)
        if us > 0:
            break
        log("(f) the profiler saw no device time; profiling again")
    else:
        raise AssertionError("the profiler saw no device time in 3 tries")
    kernels = sum(e.count for e in events
                  if not e.key.startswith(("Memcpy", "Memset")))
    return us / 1e3 / iters, kernels / iters


def device_ms(fn, iters: int = 10) -> float:
    """Mean device time per call (see `device_profile`)."""
    return device_profile(fn, iters)[0]


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sort_bound(S: int, N: int, n_arrays: int):
    """Each array read and written once; about N log2 N compares a row."""
    return bound_ms(2 * n_arrays * S * N * 4, S * N * np.log2(N))


def pack_bound(S: int, N: int, q: int, sig_words: int):
    """Four int32 token arrays and nbytes read, the int32 output words
    written, once."""
    from density_tpu_torch.kernels import packroute
    ow = packroute.out_width(N, q, sig_words)
    return bound_ms(4 * S * N * 4 + S * 4 + S * ow * 4, 0)


def kernel_modules() -> dict:
    from density_tpu_torch.kernels import (
        bigsort, bitonic, fsm, mtf, pack, packroute, unpack)
    return {"bigsort": bigsort, "packroute": packroute, "unpack": unpack,
            "pack": pack, "bitonic": bitonic, "mtf": mtf, "fsm": fsm}


def reset_counts() -> None:
    from density_tpu_torch.kernels import mtf
    for m in kernel_modules().values():
        m.launches = 0
    for k in mtf.launches_k:
        mtf.launches_k[k] = 0


def read_counts() -> dict:
    """Each kernel's launches, and the MTF kernel's by K as "mtf5" and
    "mtf2"."""
    from density_tpu_torch.kernels import mtf
    counts = {k: m.launches for k, m in kernel_modules().items()}
    counts.update({f"mtf{k}": n for k, n in mtf.launches_k.items()})
    return counts


def sort_inputs(rng, dev, S: int, N: int, n_arrays: int, n_keys: int,
                ties: bool):
    """Seeded sort operands: keys in -50..49 (many ties) or over all of
    int32, the carried arrays over all of int32."""
    import torch
    hi = [50 if ties else 2**31] * n_keys + [2**31] * (n_arrays - n_keys)
    return tuple(torch.from_numpy(rng.integers(
        -h, h, (S, N), dtype=np.int64).astype(np.int32)).to(dev) for h in hi)


def geometry_tokens(rng, S: int, N: int, q: int, flag_bits: int, nbytes):
    """Seeded flags with their payload words (zero past nbytes // 4) and
    random w0/w1, as a cheetah (2-bit) or lion (3-bit) plan has them."""
    import torch
    from density_tpu_torch.kernels import unpack
    real = np.arange(N)[None, :] < (nbytes[:, None] // 4)
    flags = np.where(real, rng.integers(0, 1 << flag_bits, (S, N)), 0)
    pw = unpack.flag_payload_words(torch.from_numpy(flags), flag_bits)
    pw = np.where(real, pw.numpy(), 0)
    w0, w1 = (rng.integers(0, 1 << 16, (S, N)) for _ in range(2))
    return [torch.from_numpy(x.astype(np.int32)) for x in (flags, pw, w0, w1)]


def geometry_blocks(rng, S: int, NB: int, q: int, sig_words: int):
    """Seeded compressed words with back-to-back block offsets (each block
    a random length up to its largest), a tenth of the blocks copy
    blocks, a tenth dead, the last blocks reading past W, and junk above
    the 16 bits of each word."""
    import torch
    span = sig_words + 2 * q
    lens = rng.integers(sig_words, span + 1, (S, NB))
    woff = (np.cumsum(lens, axis=1) - lens).astype(np.int32)
    is_copy = rng.random((S, NB)) < 0.1
    woff[rng.random((S, NB)) < 0.1] = -1
    W = int(woff.max()) + sig_words + 5
    words = rng.integers(0, 1 << 16, (S, W)).astype(np.int32)
    words |= rng.integers(0, 2, (S, W)).astype(np.int32) << 20
    return [torch.from_numpy(x) for x in (words, woff, is_copy)]


def host_syncs(fn, held: list | None = None) -> int:
    """The host syncs that PyTorch's CUDA sync debug mode reports in one
    warm call of `fn` (it sees PyTorch's own syncs: copies to the host,
    `.item()`, stream synchronisation), the workers' too. With `held`,
    appends the port's line of each sync that a share's worker made while
    it held the host's turn (`density_tpu_torch.hostsync`)."""
    import traceback
    import warnings
    import torch
    if held is not None:
        from density_tpu_torch.hostsync import holds_turn
    fn()
    torch.cuda.synchronize()
    syncs = []

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            syncs.append(held is not None and holds_turn() and next(
                (f"{f.filename}:{f.lineno}"
                 for f in reversed(traceback.extract_stack())
                 if "density_tpu_torch" in f.filename), "outside the port"))
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if held is not None:
        held += [s for s in syncs if s]
    return len(syncs)


# ---------------------------------------------------------------- phases

def phase_build() -> None:
    from density_tpu_torch import native
    from density_tpu_torch.kernels import _build
    from density_tpu_torch.native import build as native_build
    t = time.time()
    logs = _build.build()
    log(f"(a) built {sorted(logs) or 'nothing (cached)'} "
        f"in {time.time() - t:.1f} s")
    t = time.time()
    if not native.is_available():
        raise AssertionError(f"the native runtime did not build: "
                             f"{native._load_error}")
    log(f"(a) native host runtime {native_build.lib_path().name} ready in "
        f"{time.time() - t:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in logs.items():
            f.write(f"== {name}\n{text}\n")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line:
                log(f"    {name}: {line.strip()}")


def path_inputs(dev, data: bytes, stream: int = STREAM):
    """Staged encode inputs of the full streams of `stream` bytes (38 at
    the main path's 256 KiB), the plan the path hands its pack kernel,
    the staged decode inputs, the compressed payload's bytes and the
    container."""
    import torch
    from density_tpu_torch import container
    from density_tpu_torch.codecs import chameleon
    from density_tpu_torch.engine import layout
    from density_tpu_torch.parallel import sharding
    s_full = len(data) // stream
    buf = np.frombuffer(data, np.uint8)
    quads, nbytes = sharding.stage_encode(
        buf[:s_full * stream], s_full * stream, s_full,
        layout.bucket_bytes(stream, 256), stream, dev)
    # three streams end ragged (tails 1, 3 and 555 bytes)
    nb_rag = nbytes.clone()
    nb_rag[1:4] -= torch.tensor([1, 3, 555], dtype=torch.int32, device=dev)
    flags, pw, w0, w1, _, _ = chameleon.plan_fast(quads, nb_rag)
    w0, w1 = layout.stamp_ragged(quads, nb_rag, w0, w1)
    blob = container.compress(data[:s_full * stream], "chameleon", stream,
                              device=dev)
    dargs, streams, _ = sharding.decode_prep(blob, dev)
    live_bytes = sum(len(s) for s in streams)  # compressed payload
    return (quads, nbytes, (flags, pw, w0, w1, nb_rag), dargs, live_bytes,
            blob)


def phase_parity(dev, data: bytes, rnd: bytes):
    """Each kernel against its plain version, on the card, bit-exact."""
    import torch
    from density_tpu_torch.errors import DecodeError
    from density_tpu_torch.kernels import bigsort, packroute, unpack
    from density_tpu_torch.parallel import sharding
    errs = {}
    rng = np.random.default_rng(0)
    inputs = path_inputs(dev, data)
    quads, nbytes, pack_in, dargs, _, _ = inputs
    S, N = quads.shape
    # sort: the encode's forward sort (biased hash|index key + quad);
    # tie-heavy keys, where only the same network puts the carried arrays
    # in the same order, at the paths' shapes and at rows of 2^15-2^17
    # (merges with global launches of 2-3, 2-4 and 1-4 bits) at small and
    # large S; random keys
    cases = [((main_key(dev, quads), quads), 1)]
    for (s, n), na, nk, ties in [
            ((S, N), 2, 1, True), ((S, N), 1, 1, True),
            ((311, 8192), 2, 1, True), ((622, 4096), 3, 2, True),
            ((1, 1 << 15), 2, 2, True), ((150, 1 << 15), 3, 1, True),
            ((2, 1 << 17), 3, 2, True), ((64, 1 << 17), 2, 1, True),
            ((2, 1 << 17), 2, 2, False), ((4, 16384), 3, 2, False),
            ((3, 256), 1, 1, False)]:
        cases.append((sort_inputs(rng, dev, s, n, na, nk, ties), nk))
    err = 0
    for arrs, nk in cases:
        got = bigsort.sort(*arrs, n_keys=nk)
        torch.cuda.synchronize()
        want = bigsort.sort_plain(*arrs, n_keys=nk)
        err = max(err, max_abs_err(got, want))
        ref = torch.sort(arrs[0], dim=1).values
        if not torch.equal(got[0], ref):
            raise AssertionError("bigsort keys are not sorted")
    errs["bigsort"] = err
    log(f"(b) bigsort: {len(cases)} cases (N 256-131072, S 1-622, 1-3 "
        f"arrays, 1-2 keys, tie-heavy keys in -50..49), max_abs_err {err}")

    kw = dict(q=64, sig_words=4, block=256, flag_bits=1)
    got = packroute.pack(*pack_in, **kw)
    torch.cuda.synchronize()
    errs["packroute"] = max_abs_err(got, packroute.pack_plain(*pack_in, **kw))
    log(f"(b) packroute: S={S} N={N} with tails 1/3/555, "
        f"max_abs_err {errs['packroute']}")
    # the three geometries at 16384 ... 2^23 quads: ragged tails of 0-3
    # bytes, streams ending inside a block, padding blocks, an empty one
    err = errs["packroute"]
    for N_g, S_g in ((16384, 12), (65536, 12), (1 << 18, 8), (1 << 23, 1)):
        for q, sw, fb in ((64, 4, 1), (32, 4, 2), (16, 3, 3)):
            full = 4 * N_g
            nb = np.array([full, full - 1, full - 2, full - 3, 1000, 0,
                           full // 3 + 1, 4 * q * 5, 13, full - 4 * q - 2,
                           full // 2, 2 * q + 3][:S_g], np.int32)
            toks = [x.to(dev) for x in geometry_tokens(rng, S_g, N_g, q, fb,
                                                        nb)]
            toks.append(torch.from_numpy(nb).to(dev))
            kw = dict(q=q, sig_words=sw, block=4 * q, flag_bits=fb)
            got = packroute.pack(*toks, **kw)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, packroute.pack_plain(*toks,
                                                                 **kw)))
    errs["packroute"] = err
    log("(b) packroute: geometries (64, 4, 1), (32, 4, 2), (16, 3, 3) at "
        f"N 16384/65536/2^18/2^23, max_abs_err {err}")

    ukw = dict(q=64, sig_words=4, flag_bits=1)
    words, woff, is_copy, nb_real, _ = dargs
    live = torch.arange(woff.shape[1], device=dev)[None, :] < nb_real[:, None]
    woff_k = torch.where(live, woff, -1)
    err = max_abs_err(unpack.unpack(words, woff_k, is_copy, **ukw),
                      unpack.unpack_plain(words, woff_k, is_copy, **ukw))
    # a stream with copy blocks
    from density_tpu_torch import container
    rblob = container.compress(rnd, "chameleon", STREAM, device=dev)
    (rw, rwo, rcp, rnb, _), _, _ = sharding.decode_prep(rblob, dev)
    if not bool(rcp.any()):
        raise AssertionError("random input produced no copy blocks")
    rlive = torch.arange(rwo.shape[1], device=dev)[None, :] < rnb[:, None]
    rwo = torch.where(rlive, rwo, -1)
    got = unpack.unpack(rw, rwo, rcp, **ukw)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(got, unpack.unpack_plain(rw, rwo, rcp, **ukw)))
    bad = woff_k.clone()
    bad[0, 5] = words.shape[1] + 7
    try:
        unpack.unpack(words, bad, is_copy, **ukw)
    except DecodeError:
        pass
    else:
        raise AssertionError("malformed offset did not raise DecodeError")
    torch.cuda.synchronize()
    for q, sw, fb, NB in ((64, 4, 1, 1024), (32, 4, 2, 512),
                          (16, 3, 3, 1024)):
        gw, gwo, gcp = geometry_blocks(rng, 5, NB, q, sw)
        gkw = dict(q=q, sig_words=sw, flag_bits=fb)
        args = [x.to(dev) for x in (gw, gwo, gcp)]
        got = unpack.unpack(*args, **gkw)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, unpack.unpack_plain(*args, **gkw)))
        gwo[2, NB // 2] = gw.shape[1] - sw + 1  # its signature overruns W
        gcp[2, NB // 2] = False
        args = [x.to(dev) for x in (gw, gwo, gcp)]
        *got, flag = unpack.unpack_flagged(*args, **gkw)
        *want, wflag = unpack._plain(*args, q, sw, fb)
        if int(flag[0]) != 1 or int(wflag[0]) != 1:
            raise AssertionError("unpack did not flag a malformed block")
        err = max(err, max_abs_err(tuple(got), tuple(want)))
    log(f"(b) unpack: main path + copy blocks, flag_bits 1-3 with copy, "
        f"dead and malformed blocks, max_abs_err {err}; malformed offsets "
        "raised DecodeError or set the flag")

    # the small-stream paths (and their 4096-quad decode)
    small = {stream: path_inputs(dev, data, stream) for stream in SMALL_STREAMS}
    for stream, (_, _, _, (w, wo, cp, nbr, _), _, _) in small.items():
        wl = torch.where(torch.arange(wo.shape[1], device=dev)[None, :]
                         < nbr[:, None], wo, -1)
        got = unpack.unpack(w, wl, cp, **ukw)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, unpack.unpack_plain(w, wl, cp, **ukw)))
    errs["unpack"] = err
    log(f"(b) unpack: NB*64 = 8192 and 4096 (small streams), "
        f"max_abs_err {err}")
    errs.update(parity_small(dev, inputs, small))
    return errs, inputs, small


def parity_small(dev, inputs, small):
    """The pack and bitonic kernels against their plain versions (and
    bitonic against bigsort) on the card, bit-exact."""
    import torch
    from density_tpu_torch.kernels import bigsort, bitonic, pack
    errs = {}
    rng = np.random.default_rng(4)
    # pack: chameleon plans of the corpus at 8192, 4096 and 65536 quads
    # (three streams ragged), then the cheetah and lion geometries
    cases = [(small[st][2], CHAM) for st in SMALL_STREAMS]
    cases.append((inputs[2], CHAM))
    for (q, sw, fb), N in (((32, 4, 2), 8192), ((16, 3, 3), 4096)):
        nb = np.full(64, 4 * N, np.int32)
        nb[1:5] -= np.array([1, 3, 555, 4 * N - 999], np.int32)
        toks = geometry_tokens(rng, 64, N, q, fb, nb)
        cases.append(([x.to(dev) for x in toks]
                      + [torch.from_numpy(nb).to(dev)],
                      dict(q=q, sig_words=sw, block=4 * q, flag_bits=fb)))
    err = 0
    for args, kw in cases:
        got = pack.pack(*args, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, pack.pack_plain(*args, **kw))
        log(f"(b) pack: S={args[0].shape[0]} N={args[0].shape[1]} "
            f"q={kw['q']} flag_bits={kw['flag_bits']}, max_abs_err {e}")
        err = max(err, e)
    errs["pack"] = err

    # bitonic: the planners' forward sorts, then random keys with ties:
    # rows of one CTA, of one cluster of 4 or 8 CTAs, and longer rows
    # (cluster spans merged by global launches)
    sorts = [((main_key(dev, quads), quads), 1)
             for quads in (small[SMALL_STREAMS[1]][0], inputs[0])]
    for (S, N), na, nk in [((16, 4096), 3, 2), ((8, 16384), 3, 2),
                           ((4, 16384), 1, 1), ((40, 32768), 2, 1),
                           ((4, 65536), 3, 2), ((2, 1 << 17), 2, 2),
                           ((2, 1 << 17), 1, 1), ((2, 1 << 18), 3, 2)]:
        arrs = [torch.from_numpy(rng.integers(-60, 60, (S, N)).astype(
            np.int32)).to(dev) for _ in range(nk)]
        arrs += [torch.from_numpy(rng.integers(
            -2**31, 2**31, (S, N), dtype=np.int64).astype(np.int32)).to(dev)
            for _ in range(na - nk)]
        sorts.append((tuple(arrs), nk))
    err = 0
    for arrs, nk in sorts:
        got = bitonic.sort(*arrs, n_keys=nk)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, bitonic.sort_plain(*arrs, n_keys=nk)))
        if max_abs_err(got, bigsort.sort(*arrs, n_keys=nk)):
            raise AssertionError("bitonic differs from bigsort")
    errs["bitonic"] = err
    log(f"(b) bitonic: {len(sorts)} cases (N 4096-262144, 1-2 keys, 1-3 "
        f"arrays, tie-heavy keys in -60..59), max_abs_err {err}, equal to "
        "bigsort")
    return errs


def phase_main_path(dev, data: bytes):
    """Chameleon compress + decompress on the card, counted."""
    from density_tpu_torch import container, host_scan
    from density_tpu_torch.codecs import chameleon
    reset_counts()
    t = time.time()
    blob = container.compress(data, "chameleon", STREAM, device=dev)
    back = container.decompress(blob, device=dev)
    dt = time.time() - t
    counts = read_counts()
    check_mtf_per_plan("chameleon", counts, None)
    if back != data:
        raise AssertionError("main path round trip differs from the input")
    parts = payloads(blob)
    if len(parts) != -(-len(data) // STREAM):
        raise AssertionError("wrong stream count")
    for i in (0, len(parts) - 1):  # a full stream and the ragged tail
        cpu = payloads(container.compress(data[i * STREAM:(i + 1) * STREAM],
                                          "chameleon", STREAM, device="cpu"))
        if cpu != [parts[i]]:
            raise AssertionError(f"stream {i} differs from the CPU path")
    if host_scan.encode_scalar(data[STREAM:2 * STREAM]) != parts[1]:
        raise AssertionError("stream 1 differs from the scalar encoder")
    if chameleon.encode(TEST_DATA, device=dev) != GOLDEN["chameleon"]:
        raise AssertionError("golden vector mismatch")
    if chameleon.decode(GOLDEN["chameleon"], device=dev) != TEST_DATA:
        raise AssertionError("golden vector decode mismatch")
    log(f"(c) main path: {len(data)} bytes in {len(parts)} streams -> "
        f"{len(blob)} bytes (ratio {len(data) / len(blob):.4f}), round trip "
        f"exact in {dt:.2f} s host wall; streams 0/{len(parts) - 1} equal "
        "the CPU path, stream 1 the scalar encoder; golden vector exact")
    return counts, blob


def phase_incompressible(dev, rnd: bytes):
    from density_tpu_torch import container, host_scan
    rng = np.random.default_rng(2)
    text = corpus_bytes(1 << 20)
    mixed = b"".join(text[i:i + 65536] + rng.integers(
        0, 256, 65536, dtype=np.uint8).tobytes()
        for i in range(0, 1 << 20, 131072)) + b"xyz"
    for name, data in (("random", rnd), ("mixed", mixed)):
        blob = container.compress(data, "chameleon", STREAM, device=dev)
        if container.decompress(blob, device=dev) != data:
            raise AssertionError(f"{name}: round trip differs")
        parts = payloads(blob)
        last = len(parts) - 1
        for i in (0, last):
            if host_scan.encode_scalar(
                    data[i * STREAM:(i + 1) * STREAM]) != parts[i]:
                raise AssertionError(f"{name}: stream {i} differs from scalar")
        log(f"(d) {name}: {len(data)} bytes -> {len(blob)}, round trip "
            f"exact, streams 0/{last} equal the scalar encoder")


def phase_small_streams(dev, data: bytes):
    """Compress and decompress the corpus in 32 KiB and 16 KiB streams on
    the card, counted; three streams of each against the CPU path."""
    from density_tpu_torch import container
    reset_counts()
    blobs = {}
    for stream in SMALL_STREAMS:
        t = time.time()
        blob = container.compress(data, "chameleon", stream, device=dev)
        back = container.decompress(blob, device=dev)
        dt = time.time() - t
        if back != data:
            raise AssertionError(f"{stream}-byte streams: round trip differs")
        parts = payloads(blob)
        if len(parts) != -(-len(data) // stream):
            raise AssertionError("wrong stream count")
        for i in (0, len(parts) // 2, len(parts) - 1):
            cpu = payloads(container.compress(
                data[i * stream:(i + 1) * stream], "chameleon", stream,
                device="cpu"))
            if cpu != [parts[i]]:
                raise AssertionError(f"{stream}-byte stream {i} differs "
                                     "from the CPU path")
        blobs[stream] = blob
        log(f"(g) {stream}-byte streams: {len(data)} bytes in {len(parts)} "
            f"streams (tail {len(data) % stream} bytes) -> {len(blob)} bytes "
            f"(ratio {len(data) / len(blob):.4f}), round trip exact in "
            f"{dt:.2f} s host wall; streams 0/{len(parts) // 2}/"
            f"{len(parts) - 1} equal the CPU path")
    counts = read_counts()
    log(f"(g) launches on the small-stream paths: {counts}")
    if counts["pack"] < 1 or counts["bigsort"] < 1 or counts["unpack"] < 1:
        raise AssertionError(f"a kernel of the path was not launched: {counts}")
    if counts["packroute"] != 0:
        raise AssertionError("small streams went through packroute")
    return counts, blobs


def phase_options(dev, data: bytes, main_blob: bytes, small_blob: bytes):
    """DENSITY_TPU_SORT=bitonic and pack mode "onehot" give the default
    containers byte for byte; the bitonic path's counts are returned."""
    from density_tpu_torch import container
    from density_tpu_torch.engine import layout
    stream = SMALL_STREAMS[0]
    reset_counts()
    os.environ["DENSITY_TPU_SORT"] = "bitonic"
    try:
        big = container.compress(data, "chameleon", STREAM, device=dev)
        small = container.compress(data, "chameleon", stream, device=dev)
        back = container.decompress(small, device=dev)
    finally:
        del os.environ["DENSITY_TPU_SORT"]
    counts = read_counts()
    if big != main_blob or small != small_blob or back != data:
        raise AssertionError("DENSITY_TPU_SORT=bitonic changed a container")
    if counts["bitonic"] < 1:
        raise AssertionError(f"the bitonic kernel was not launched: {counts}")
    log(f"(h) DENSITY_TPU_SORT=bitonic: {STREAM}- and {stream}-byte "
        f"containers byte-identical to the default; launches {counts}")
    reset_counts()
    mode, layout.PACK_MODE = layout.PACK_MODE, "onehot"
    try:
        onehot = container.compress(data, "chameleon", STREAM, device=dev)
    finally:
        layout.PACK_MODE = mode
    onehot_counts = read_counts()
    if onehot != main_blob:
        raise AssertionError("pack mode onehot changed the container")
    if onehot_counts["pack"] < 1 or onehot_counts["packroute"] != 0:
        raise AssertionError(f"onehot did not go through pack: "
                             f"{onehot_counts}")
    log(f"(h) pack mode onehot: {STREAM}-byte container byte-identical to "
        f"the default; launches {onehot_counts}")
    return counts


def phase_api(dev, data: bytes) -> None:
    """encode_raw/decode_raw on the card against the scalar backend and
    the CPU path."""
    from density_tpu_torch import api
    msgs = [data[7 * n:8 * n] for n in (0, 1, 255, 1000, 16384, 32771)]
    msgs.append(np.random.default_rng(5).integers(
        0, 256, 32 << 10, dtype=np.uint8).tobytes())
    for msg in msgs:
        enc = api.encode_raw(msg, device=dev)
        if (enc != api.encode_raw(msg, backend="scalar")
                or enc != api.encode_raw(msg, device="cpu")):
            raise AssertionError(f"encode_raw of {len(msg)} bytes differs")
        for dec in (api.decode_raw(enc, device=dev),
                    api.decode_raw(enc, backend="scalar"),
                    api.decode_raw(enc, device="cpu")):
            if dec != msg:
                raise AssertionError(f"decode_raw of {len(msg)} bytes differs")
    log(f"(i) encode_raw/decode_raw on the card: {[len(m) for m in msgs]} "
        "bytes, equal to the scalar backend and the CPU path")


def phase_large_streams(dev, data: bytes):
    """Compress and decompress the corpus in 1 MiB streams (2^18 quads)
    and in the default 32 MiB stream (one stream, 2^22 quads) on the
    card, counted; stream 0 of the 1 MiB container against the CPU path,
    and a 2 MiB prefix at the default stream size against the CPU path
    (which keeps the CPU side at 2^19 quads). Returns the counts and the
    containers by stream size."""
    from density_tpu_torch import container
    reset_counts()
    blobs = {}
    for stream in LARGE_STREAMS:
        t = time.time()
        blob = container.compress(data, "chameleon", stream, device=dev)
        back = container.decompress(blob, device=dev)
        dt = time.time() - t
        if back != data:
            raise AssertionError(f"{stream}-byte streams: round trip differs")
        parts = payloads(blob)
        if len(parts) != -(-len(data) // stream):
            raise AssertionError("wrong stream count")
        blobs[stream] = blob
        if len(data) > stream:
            what = "stream 0 equals"
            same = payloads(container.compress(
                data[:stream], "chameleon", stream, device="cpu")) == [
                    parts[0]]
        else:
            what = "a 2 MiB prefix's container equals"
            prefix = data[:2 << 20]
            same = container.compress(prefix, "chameleon", stream,
                                      device=dev) == container.compress(
                prefix, "chameleon", stream, device="cpu")
        if not same:
            raise AssertionError(f"{stream}-byte streams differ from the "
                                 "CPU path")
        log(f"(j) {stream}-byte streams: {len(data)} bytes in {len(parts)} "
            f"stream(s) -> {len(blob)} bytes (ratio "
            f"{len(data) / len(blob):.4f}), round trip exact in {dt:.2f} s "
            f"host wall; {what} the CPU path")
    counts = read_counts()
    log(f"(j) launches on the large-stream paths: {counts}")
    if min(counts[k] for k in ("bigsort", "packroute", "unpack")) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {counts}")
    return counts, blobs


def time_paths(name: str, quads, nbytes, dargs):
    """Median of REPEATS windows of the device-resident encode and decode."""
    from density_tpu_torch.codecs import chameleon
    from density_tpu_torch.engine import layout
    from density_tpu_torch.parallel import sharding
    S, N = quads.shape
    enc_bytes = int(nbytes.sum())

    def enc():
        return layout.run_encode(chameleon.PIPELINE, quads, nbytes)
    _, _, conv = enc()
    if not conv:
        raise AssertionError("timed encode did not converge")
    # both are bound by the host, whose speed varies from call to call:
    # the median of REPEATS windows of 10 calls each, with the range
    times = {}
    for what, fn in (("encode", enc),
                     ("decode", lambda: sharding.decode_batch(*dargs))):
        runs = sorted(timed_ms(fn) for _ in range(REPEATS))
        times[what] = statistics.median(runs)
        log(f"(f) device-resident {what} {name} S={S} N={N}: median "
            f"{times[what]:.3f} ms = {enc_bytes / times[what] / 1e6:.3f} "
            f"GB/s of input (range {runs[0]:.3f}-{runs[-1]:.3f} ms, "
            f"{REPEATS} windows of 10 calls)")
    return enc


def phase_small_timing(dev, inputs, small):
    """Small-stream encode/decode throughput; the pack and bitonic rows."""
    from density_tpu_torch.kernels import pack
    from density_tpu_torch.parallel import sharding
    encs = {}
    for stream in SMALL_STREAMS:
        quads, nbytes, _, dargs, _, _ = small[stream]
        encs[stream] = time_paths(f"{stream >> 10} KiB", quads, nbytes,
                                  dargs)
    rows = {}
    shapes = [(small[st][2], f"{st >> 10} KiB") for st in SMALL_STREAMS]
    shapes.append((inputs[2], "256 KiB, onehot"))
    for i, (pack_in, what) in enumerate(shapes):
        S, N = pack_in[0].shape
        r = dict(
            ms=device_ms(lambda: pack.pack(*pack_in, **CHAM)),
            plain_ms=device_ms(lambda: pack.pack_plain(*pack_in, **CHAM),
                               iters=3),
            library_ms=None, bound=pack_bound(S, N, 64, 4),
            shape=f"S={S} N={N}, {what}; 1 launch per encode call")
        log_row("pack", r)
        if i == 0:
            rows["pack"] = r
    rows["bitonic"] = time_bitonic(dev, inputs, small)
    st = SMALL_STREAMS[0]
    phase_profile({"small_encode": encs[st], "small_decode":
                   lambda: sharding.decode_batch(*small[st][3])})
    time_sort_option(inputs, small)
    return rows


def time_bitonic(dev, inputs, small) -> dict:
    """bitonic at each shape the planner sorts under the option (its
    forward sort, 1 key and 2 arrays, and its unsort, 1 array) on the
    main path's keys and the 32 KiB and 16 KiB paths', with bigsort and
    `torch.sort` beside it and the clusters the card holds at once; then
    the planner's 2-key sort of one stream of the default 32 MiB (2^23
    quads: cluster spans merged by global launches). Returns the main
    shape's row (2 arrays)."""
    import torch
    from density_tpu_torch.kernels import bigsort, bitonic
    main = None
    for quads in (inputs[0], small[SMALL_STREAMS[0]][0],
                  small[SMALL_STREAMS[1]][0]):
        S, N = quads.shape
        key = main_key(dev, quads)
        for arrs in ((key, quads), (key,)):
            ms, n = device_profile(lambda: bitonic.sort(*arrs, n_keys=1))
            resident = (f"; {bitonic.resident_clusters(len(arrs), 1, N)} "
                        f"clusters of {N >> 13} CTAs resident at once, "
                        f"{S} to run" if N > 16384 else "")
            r = dict(
                ms=ms,
                # the plain version on the main shape only (9 ms a call)
                plain_ms=None if main else device_ms(
                    lambda: bitonic.sort_plain(*arrs, n_keys=1), iters=2),
                library_ms=device_ms(lambda: torch.sort(key, dim=1)),
                bigsort_ms=device_ms(lambda: bigsort.sort(*arrs, n_keys=1)),
                bound=sort_bound(S, N, len(arrs)),
                shape=f"S={S} N={N} 1 key {len(arrs)} array(s); {n:g} "
                      f"kernel launches per sort in the trace{resident}")
            main = main or r
            log_row("bitonic", r)
    arrs = sort_inputs(np.random.default_rng(6), dev, 1, 1 << 23, 2, 2, False)
    ms, n = device_profile(lambda: bitonic.sort(*arrs, n_keys=2), iters=3)
    log_row("bitonic", dict(
        ms=ms, plain_ms=None,
        library_ms=device_ms(lambda: torch.sort(arrs[0], dim=1), iters=3),
        bigsort_ms=device_ms(lambda: bigsort.sort(*arrs, n_keys=2), iters=3),
        bound=sort_bound(1, 1 << 23, 2),
        shape=f"S=1 N={1 << 23} 2 keys 2 arrays; {n:g} kernel launches per "
              "sort in the trace"))
    return main


def time_sort_option(inputs, small) -> None:
    """Encode with the default sort and under DENSITY_TPU_SORT=bitonic,
    in turns (default, bitonic, bitonic, default; 2 windows of 10 calls
    each turn), with each one's device time per call: does one launch
    per sort instead of bigsort's several show end to end?"""
    from density_tpu_torch.codecs import chameleon
    from density_tpu_torch.engine import layout
    for name, (quads, nbytes) in (("256 KiB", inputs[:2]),
                                  ("32 KiB", small[SMALL_STREAMS[0]][:2])):
        def enc():
            return layout.run_encode(chameleon.PIPELINE, quads, nbytes)
        runs = {"default": [], "bitonic": []}
        dev_ms = {}
        for which in ("default", "bitonic", "bitonic", "default"):
            if which == "bitonic":
                os.environ["DENSITY_TPU_SORT"] = "bitonic"
            try:
                runs[which] += [timed_ms(enc) for _ in range(2)]
                dev_ms.setdefault(which, device_ms(enc, iters=5))
            finally:
                os.environ.pop("DENSITY_TPU_SORT", None)
        for which, r in runs.items():
            r.sort()
            log(f"(f) encode {name} S={quads.shape[0]} N={quads.shape[1]}, "
                f"sort {which}: median {statistics.median(r):.3f} ms "
                f"(range {r[0]:.3f}-{r[-1]:.3f}, {len(r)} windows of 10 "
                f"calls, in turns), device {dev_ms[which]:.4f} ms per call")


def log_row(name: str, r: dict) -> None:
    lib, plain = (f"{r[k]:.4f}" if r[k] is not None else "n/a"
                  for k in ("library_ms", "plain_ms"))
    big = (f", bigsort {r['bigsort_ms']:.4f} ms" if "bigsort_ms" in r
           else "")
    log(f"(f) {name} [{r['shape']}]: device {r['ms']:.4f} ms, plain "
        f"{plain} ms, library {lib} ms{big}, bound "
        f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")


def phase_timing(dev, inputs, small):
    import torch
    from density_tpu_torch.kernels import packroute, unpack
    from density_tpu_torch.parallel import sharding
    quads, nbytes, pack_in, dargs, live_bytes, _ = inputs
    S, N = quads.shape
    enc = time_paths("256 KiB", quads, nbytes, dargs)

    rows = {"bigsort": time_bigsort(dev, inputs, small)}
    # (a dropped profiler event reads as 0.9 launches: round)
    ms, n = device_profile(lambda: packroute.pack(*pack_in, **CHAM))
    if round(n) != 1:
        raise AssertionError(f"packroute made {n:g} kernel launches a call")
    rows["packroute"] = dict(
        ms=ms,
        plain_ms=device_ms(
            lambda: packroute.pack_plain(*pack_in, **CHAM), iters=3),
        library_ms=None, bound=pack_bound(S, N, 64, 4),
        shape=f"S={S} N={N}; {n:g} kernel launch per call in the trace")
    words, woff, is_copy, nb_real, _ = dargs
    live = torch.arange(woff.shape[1], device=dev)[None, :] < nb_real[:, None]
    woff_k = torch.where(live, woff, -1)
    ukw = dict(q=64, sig_words=4, flag_bits=1)
    W, NB = words.shape[1], woff.shape[1]
    ms, n = device_profile(
        lambda: unpack.unpack_flagged(words, woff_k, is_copy, **ukw))
    if round(n) != 1:
        raise AssertionError(f"unpack made {n:g} kernel launches a call")
    rows["unpack"] = dict(
        ms=ms,
        plain_ms=device_ms(
            lambda: unpack.unpack_plain(words, woff_k, is_copy, **ukw),
            iters=3),
        library_ms=None,
        # the words it needs are the compressed payload's, 4 bytes each
        bound=bound_ms(2 * live_bytes + S * NB * 5 + 3 * S * NB * 64 * 4,
                       0),
        shape=f"S={S} W={W} NB={NB}; {n:g} kernel launch (and a 4-byte "
              "memset of the flag) per call in the trace")
    for name in ("packroute", "unpack"):
        log_row(name, rows[name])
    time_packroute_geometries(dev)
    phase_profile({"encode": enc,
                   "decode": lambda: sharding.decode_batch(*dargs)})
    blob = inputs[5]
    log(f"(f) host syncs per call (CUDA sync debug mode): device-resident "
        f"decode {host_syncs(lambda: sharding.decode_batch(*dargs))}, "
        f"decompress of the 256 KiB container "
        f"{host_syncs(lambda: sharding.decompress(blob, dev))}, "
        f"device-resident encode {host_syncs(enc)}")
    return rows


def time_packroute_geometries(dev) -> None:
    """packroute at the three geometries at 2^18 quads (S=8) and on one
    stream of 2^23 quads (the default 32 MiB), with its kernel launches
    per call."""
    import torch
    from density_tpu_torch.kernels import packroute
    rng = np.random.default_rng(7)
    for (q, sw, fb), S, N in (((64, 4, 1), 8, 1 << 18),
                              ((32, 4, 2), 8, 1 << 18),
                              ((16, 3, 3), 8, 1 << 18),
                              ((64, 4, 1), 1, 1 << 23)):
        nb = np.full(S, 4 * N, np.int32)
        toks = [x.to(dev) for x in geometry_tokens(rng, S, N, q, fb, nb)]
        toks.append(torch.from_numpy(nb).to(dev))
        kw = dict(q=q, sig_words=sw, block=4 * q, flag_bits=fb)
        ms, n = device_profile(lambda: packroute.pack(*toks, **kw))
        log_row("packroute", dict(
            ms=ms, plain_ms=None, library_ms=None,
            bound=pack_bound(S, N, q, sw),
            shape=f"S={S} N={N} q={q} flag_bits={fb}; {n:g} kernel launch "
                  "per call"))


def time_bigsort(dev, inputs, small) -> dict:
    """bigsort at each shape the paths launch it, `torch.sort` beside it:
    the forward sort of the encode and the two decode sorts (1 key, 2
    arrays) and the encode's unsort (1 array), on the main path's keys
    and on the 32 KiB and 16 KiB paths'. Returns the main shape's row."""
    import torch
    from density_tpu_torch.kernels import bigsort
    main = None
    for quads in (inputs[0], small[SMALL_STREAMS[0]][0],
                  small[SMALL_STREAMS[1]][0]):
        S, N = quads.shape
        key = main_key(dev, quads)
        for arrs in ((key, quads), (key,)):
            ms, n = device_profile(lambda: bigsort.sort(*arrs, n_keys=1))
            r = dict(
                ms=ms,
                # the plain version on the main shape only (9 ms a call)
                plain_ms=None if main else device_ms(
                    lambda: bigsort.sort_plain(*arrs, n_keys=1), iters=2),
                library_ms=device_ms(lambda: torch.sort(key, dim=1)),
                bound=sort_bound(S, N, len(arrs)),
                shape=f"S={S} N={N} 1 key {len(arrs)} array(s); {n:g} "
                      "kernel launches per sort in the trace")
            main = main or r
            log_row("bigsort", r)
    return main


def main_key(dev, quads):
    """The encode's forward-sort key: biased (hash << 16 | index)."""
    import torch
    from density_tpu_torch.engine import grouping
    N = quads.shape[1]
    return ((grouping.hash_quads(quads) << 16)
            | torch.arange(N, dtype=torch.int32, device=dev)) ^ (-2**31)


def phase_profile(fns) -> None:
    """One traced call of each device-resident function: wall time, the
    device's busy time (the sum of its kernels' self times) and the
    kernels that take it. Full tables go to OUT_DIR."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        ka = prof.key_averages()
        # the device's own events (kernels, copies, memsets); the aten
        # rows repeat their kernels' time and are left out of the sum
        rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                       for e in ka if device_work(e)
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[2])
        busy = sum(r[2] for r in rows)
        with open(os.path.join(OUT_DIR, f"profile_{name}.txt"),
                  "w") as f:
            f.write(f"wall {wall:.4f} ms, device busy {busy:.4f} ms\n\n")
            f.write("".join(f"{ms:10.4f} ms x{c:4d}  {k}\n"
                            for k, c, ms in rows))
            f.write("\n" + ka.table(sort_by="self_cpu_time_total",
                                    row_limit=40))
        share = (f"{100 * busy / wall:.1f}% busy" if busy > 0
                 else "device time not measured")
        log(f"(f) profile {name}: {wall:.3f} ms wall traced, device "
            f"{busy:.3f} ms ({share}); top: " + "; ".join(
                f"{k[:48]} x{c} {ms:.3f} ms" for k, c, ms in rows[:5]))


# ---------------------------------------------------------- cheetah, lion

# each codec's pack geometry and the phase letters of its main path,
# converging decode, stream sizes and edge inputs
GEOM = {"cheetah": CHEE, "lion": LION}
TAGS = {"cheetah": dict(main="k", conv="l", sizes="n", edges="o"),
        "lion": dict(main="p", conv="q", sizes="r", edges="s")}


def stream_chunks(data: bytes, stream: int) -> list[bytes]:
    return [data[i:i + stream] for i in range(0, len(data), stream)]


def alphabet_input(seed: int) -> bytes:
    """38 x 256 KiB of quads drawn i.i.d. from 1024 seeded values (top
    bits included): map tokens are common, predictions rare."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 32, 1024, dtype=np.uint64).astype(np.uint32)
    return vals[rng.integers(0, 1024, 38 * STREAM // 4)].tobytes()


def compress_on_device(dev, data: bytes, codec: str, stream: int):
    """container.compress on the card, failing if any batch was left to
    the native encoder (a fixed point that did not converge): the bytes
    must be the card's. Returns the container and the plans the batches
    made and the passes of their fixed points: (copy-free plans, masked
    ones, FSM steps)."""
    from density_tpu_torch import container, native
    from density_tpu_torch.engine import layout
    calls, fast, plans, steps = [], [], [], []
    many, fused, masked, step = (native.encode_many, layout.fused,
                                 layout.plan_masked, layout.step_fsm)
    native.encode_many = lambda *a: calls.append(1) or many(*a)
    layout.fused = lambda *a: fast.append(1) or fused(*a)
    layout.plan_masked = lambda *a: plans.append(1) or masked(*a)
    layout.step_fsm = lambda *a: steps.append(1) or step(*a)
    try:
        blob = container.compress(data, codec, stream, device=dev)
    finally:
        (native.encode_many, layout.fused, layout.plan_masked,
         layout.step_fsm) = (many, fused, masked, step)
    if calls:
        raise AssertionError(f"{codec} at {stream}-byte streams: {len(calls)} "
                             "batch(es) went to the native encoder")
    return blob, (len(fast), len(plans), len(steps))


def check_mtf_per_plan(codec: str, counts: dict, plans) -> None:
    """(e) Lion's planner scans its prediction queue once a plan, in one
    K=5 launch of the MTF kernel; cheetah's and lion's copy-free plans
    scan their dictionaries in one K=2 launch each (the masked plans in
    closed form, `mru2_state_in_group`); chameleon launches neither."""
    want = {"mtf5": 0, "mtf2": 0}
    if codec != "chameleon":
        want["mtf2"] = plans[0]
    if codec == "lion":
        want["mtf5"] = plans[0] + plans[1]
    got = {k: counts[k] for k in want}
    if got != want or counts["mtf"] != sum(want.values()):
        where = (f" for {plans[0]} copy-free and {plans[1]} masked plans"
                 if plans else "")
        raise AssertionError(f"{codec}: MTF launches {got} (all K: "
                             f"{counts['mtf']}){where}, want {want}")


def check_fsm_per_pass(codec: str, counts: dict, plans) -> None:
    """(e) Each pass of a fixed point steps the protection FSM in one
    launch of its kernel, in every codec."""
    if counts["fsm"] != plans[2]:
        raise AssertionError(f"{codec}: {counts['fsm']} FSM launches for "
                             f"{plans[2]} passes of the fixed point")


def codec_inputs(dev, data: bytes, codec: str, stream: int = STREAM):
    """A codec's path inputs at `stream`-byte streams: staged encode quads
    and nbytes of the full streams, the plan the path hands its pack
    kernel (three streams ending ragged), the container, and its staged
    decode inputs."""
    import torch
    from density_tpu_torch import container
    from density_tpu_torch.constants import SPECS
    from density_tpu_torch.engine import layout
    from density_tpu_torch.parallel import sharding
    s_full = len(data) // stream
    buf = np.frombuffer(data, np.uint8)
    quads, nbytes = sharding.stage_encode(
        buf[:s_full * stream], s_full * stream, s_full,
        layout.bucket_bytes(stream, SPECS[codec].block_size), stream, dev)
    nb_rag = nbytes.clone()
    nb_rag[1:4] -= torch.tensor([1, 3, 555], dtype=torch.int32, device=dev)
    flags, pw, w0, w1, _, _ = sharding.codec_module(codec).plan_fast(quads, nb_rag)
    w0, w1 = layout.stamp_ragged(quads, nb_rag, w0, w1)
    blob = container.compress(data[:s_full * stream], codec, stream,
                              device=dev)
    dargs, streams, meta = sharding.decode_prep(blob, dev)
    return dict(quads=quads, nbytes=nbytes,
                pack_in=(flags, pw, w0, w1, nb_rag), blob=blob, dargs=dargs,
                streams=streams, meta=meta)


def resolve_sort_inputs(dargs, codec: str):
    """The resolve's dictionary sort operands (key, index|op|flags, plain
    quad: 3 arrays, 2 keys) of staged streams, as the codec's `resolve`
    builds them (cheetah: 2 flag bits, lion: 3)."""
    import torch
    from density_tpu_torch.engine.grouping import hash_quads
    from density_tpu_torch.parallel import sharding
    flags, w0, w1, valid = sharding.codec_module(codec).extract_tokens(*dargs)
    S, N = flags.shape
    lidx = torch.arange(N, dtype=torch.int32, device=flags.device)[None, :]
    plain_quad = w0 | (w1 << 16)
    fb = 2 if codec == "cheetah" else 3
    is_pred = ((flags == 3) if codec == "cheetah"
               else (flags >= 1) & (flags <= 5))
    nonpred = valid & ~is_pred
    is_plain = valid & (flags == 0)
    key = torch.where(nonpred, torch.where(is_plain, hash_quads(plain_quad),
                                           w0), 1 << 16)
    map_b = 2 if codec == "cheetah" else 7
    op = torch.where(is_plain, 2, torch.where((flags == map_b) & nonpred, 1,
                                              0))
    k2 = ((lidx << (fb + 2)) | (op.to(torch.int32) << fb)
          | (flags & ((1 << fb) - 1)))
    return key.contiguous(), k2.contiguous(), plain_quad.contiguous()


def planner_sort_inputs(quads):
    """The planner's forward sort operands above 65536 quads (context,
    index, fingerprint: 3 arrays, 2 keys), as cheetah's and lion's
    `plan_fast` build them."""
    import torch
    from density_tpu_torch.engine.grouping import (
        hash_quads, shift_right, sig32)
    S, N = quads.shape
    lidx = torch.arange(N, dtype=torch.int32, device=quads.device)
    return (shift_right(hash_quads(quads), 0).contiguous(),
            lidx.expand(S, N).contiguous(), sig32(quads))


def parity_codec(dev, codec, big_in, small_in, large_quads):
    """bigsort, bitonic, packroute and pack against their plain versions
    at a codec's shapes: the resolve's 3-array 2-key sort and the
    planner's (2^22 quads), the planner's packed forward sort, its unsort,
    and the plans at the codec's geometry (256 KiB: packroute, 16 KiB:
    pack). Returns the largest error of each."""
    import torch
    from density_tpu_torch.engine.grouping import (
        hash_quads, shift_right, sig32)
    from density_tpu_torch.kernels import bigsort, bitonic, pack, packroute
    errs = {}
    res = resolve_sort_inputs(big_in["dargs"], codec)
    big = planner_sort_inputs(large_quads)
    q = big_in["quads"]
    S, N = q.shape
    lidx = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    # the planner's first packed sort at N <= 65536: biased (context <<
    # 16 | index) and the fingerprint
    fwd = (((shift_right(hash_quads(q), 0) << 16) | lidx) ^ (-2**31),
           sig32(q))
    sorts = [(res, 2), ((res[2], res[1]), 1), (big, 2), (fwd, 1),
             ((res[1],), 1)]
    for name, mod in (("bigsort", bigsort), ("bitonic", bitonic)):
        err = 0
        for arrs, nk in sorts:
            got = mod.sort(*arrs, n_keys=nk)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, mod.sort_plain(*arrs, n_keys=nk)))
            if name == "bitonic" and max_abs_err(
                    got, bigsort.sort(*arrs, n_keys=nk)):
                raise AssertionError("bitonic differs from bigsort")
        errs[name] = err
        log(f"(b) {name} at {codec}'s shapes: resolve S={S} N={N} 3 arrays "
            f"2 keys, planner S=1 N={big[0].shape[1]} 3 arrays 2 keys, "
            f"planner packed sorts and unsort, max_abs_err {err}")
    for name, mod, inputs in (("packroute", packroute, big_in),
                              ("pack", pack, small_in)):
        args = inputs["pack_in"]
        got = mod.pack(*args, **GEOM[codec])
        torch.cuda.synchronize()
        errs[name] = e = max_abs_err(got, mod.pack_plain(*args,
                                                         **GEOM[codec]))
        log(f"(b) {name} at {codec}'s geometry: S={args[0].shape[0]} "
            f"N={args[0].shape[1]} (tails 1/3/555), max_abs_err {e}")
    return errs


def phase_codec_main(dev, data: bytes, codec: str):
    """(k, p) The corpus in 256 KiB streams on the card, counted, every
    batch encoded there; every stream against the native encoder, three
    against the CPU path; decompress by the container's route."""
    from density_tpu_torch import container, native
    from density_tpu_torch.parallel import sharding
    tag = TAGS[codec]["main"]
    reset_counts()
    t = time.time()
    blob, plans = compress_on_device(dev, data, codec, STREAM)
    dt = time.time() - t
    counts = read_counts()
    check_mtf_per_plan(codec, counts, plans)
    check_fsm_per_pass(codec, counts, plans)
    parts = payloads(blob)
    chunks = stream_chunks(data, STREAM)
    if parts != native.encode_many(codec, chunks):
        raise AssertionError(f"{codec} streams differ from native.encode")
    for i in (0, len(parts) // 2, len(parts) - 1):
        cpu = payloads(container.compress(chunks[i], codec, STREAM,
                                          device="cpu"))
        if cpu != [parts[i]]:
            raise AssertionError(f"{codec} stream {i} differs from the CPU "
                                 "path")
    _, streams, meta = sharding.decode_prep(blob, dev)
    t = time.time()
    back = container.decompress(blob, device=dev)
    dt_dec = time.time() - t
    if back != data:
        raise AssertionError(f"{codec} round trip differs from the input")
    log(f"({tag}) {codec} main path: {len(data)} bytes in {len(parts)} "
        f"streams -> {len(blob)} bytes (ratio {len(data) / len(blob):.4f}) "
        f"in {dt:.2f} s host wall, every batch on the card ({plans[0]} "
        f"copy-free and {plans[1]} masked plans, {plans[2]} passes of the "
        f"fixed point); every stream equals native.encode, "
        f"streams 0/{len(parts) // 2}/{len(parts) - 1} the CPU path; "
        f"decompress route {sharding.route(codec, meta[-1])} (predicted "
        f"share {meta[-1]:.4f}), round trip exact in {dt_dec:.2f} s; "
        f"launches {counts}")
    if counts["bigsort"] < 1 or counts["packroute"] < 1:
        raise AssertionError(f"a kernel of the path was not launched: "
                             f"{counts}")
    return counts, blob


def phase_codec_converging(dev, seed: int, codec: str):
    """(l, q) The device decode where the fixpoint converges: 38 x 256
    KiB of seeded alphabet quads."""
    from density_tpu_torch import container, native
    from density_tpu_torch.parallel import sharding
    tag = TAGS[codec]["conv"]
    data = alphabet_input(seed)
    blob, _ = compress_on_device(dev, data, codec, STREAM)
    if payloads(blob) != native.encode_many(codec,
                                            stream_chunks(data, STREAM)):
        raise AssertionError(f"alphabet {codec} streams differ from "
                             "native.encode")
    dargs, streams, meta = sharding.decode_prep(blob, dev)
    share = meta[-1]
    if sharding.route(codec, share) != "device":
        raise AssertionError(f"predicted share {share} takes the pool")
    reset_counts()
    out, ok, rounds = sharding.codec_module(codec).decode_batch(*dargs)
    counts = read_counts()
    if not bool(ok.all()):
        raise AssertionError("the resolve did not converge on every stream")
    got = b"".join(sharding._finish(out, None, ~ok, streams, meta[2],
                                    meta[3], meta[4], codec))
    if got != data or container.decompress(blob, device=dev) != data:
        raise AssertionError(f"{codec} device decode differs from the input")
    log(f"({tag}) {codec} alphabet input (seed {seed}): {len(data)} bytes "
        f"in {len(streams)} streams -> {len(blob)} bytes (ratio "
        f"{len(data) / len(blob):.4f}), predicted share {share:.6f}, route "
        f"device; the resolve converged on {int(ok.sum())} of {ok.numel()} "
        f"streams in {rounds} rounds, bytes exact; decode launches {counts}")
    return data, blob, dargs


def corpus_converged(dev, blob: bytes, codec: str):
    """The device decode of the corpus's 256 KiB streams at 12 rounds:
    (streams converged, streams, rounds, host seconds)."""
    from density_tpu_torch.parallel import sharding
    dargs, streams, _ = sharding.decode_prep(blob, dev)
    t = time.time()
    _, ok, rounds = sharding.codec_module(codec).decode_batch(*dargs)
    return int(ok.sum()), ok.numel(), rounds, time.time() - t


def phase_cheetah_corpus_decode(dev, data: bytes, blob: bytes):
    """(m) The device decode on the corpus's 256 KiB streams at 12 rounds;
    then three streams with max_rounds raised until they converge."""
    from density_tpu_torch.codecs import cheetah
    from density_tpu_torch.parallel import sharding
    conv, n, rounds, dt = corpus_converged(dev, blob, "cheetah")
    log(f"(m) corpus, {n} streams of 256 KiB, device decode at 12 rounds: "
        f"{conv} of {n} converged ({rounds} rounds, {dt:.3f} s)")
    streams = payloads(blob)
    pick = [0, len(streams) // 2, len(streams) - 2]  # full streams
    sub = [streams[i] for i in pick]
    out_lens = [STREAM] * len(pick)
    woff, copyf, nb_real, _ = sharding._scan("cheetah", sub, out_lens)
    sargs = sharding._stage(sub, out_lens, woff, copyf, nb_real, dev)
    want = [data[i * STREAM:(i + 1) * STREAM] for i in pick]
    rounds_cap = 12
    while True:
        out, ok, rounds = cheetah.decode_batch(*sargs, max_rounds=rounds_cap)
        if bool(ok.all()) or rounds_cap >= 1 << 14:
            break
        rounds_cap *= 2
    if not bool(ok.all()):
        raise AssertionError("corpus streams did not converge in 16384 rounds")
    got = sharding._finish(out, None, ~ok, sub, out_lens, copyf, nb_real,
                           "cheetah")
    if got != want:
        raise AssertionError("converged corpus streams differ from the input")
    log(f"(m) corpus streams {pick}: converged at max_rounds={rounds_cap} "
        f"after {rounds} rounds, bytes exact")
    return conv, rounds


def phase_codec_sizes(dev, data: bytes, codec: str, onehot: bool):
    """(n, r) The corpus in 16 KiB streams (the pack kernel) and in the
    default 32 MiB stream (the planner's 3-array sorts): compress on the
    card (every batch encoded there) against the native encoder, round trip, and the same containers
    under DENSITY_TPU_SORT=bitonic (and, with `onehot`, pack mode
    "onehot"). Returns the ratios, the 16 KiB path's counts and the
    containers by stream size."""
    from density_tpu_torch import container, native
    from density_tpu_torch.engine import layout
    tag = TAGS[codec]["sizes"]
    ratios, small_counts, blobs = {}, None, {}
    for stream in (SMALL_STREAMS[1], LARGE_STREAMS[1]):
        reset_counts()
        t = time.time()
        blob, plans = compress_on_device(dev, data, codec, stream)
        dt = time.time() - t
        counts = read_counts()
        check_mtf_per_plan(codec, counts, plans)
        check_fsm_per_pass(codec, counts, plans)
        if payloads(blob) != native.encode_many(codec,
                                                stream_chunks(data, stream)):
            raise AssertionError(f"{stream}-byte {codec} streams differ from "
                                 "native.encode")
        if container.decompress(blob, device=dev) != data:
            raise AssertionError(f"{stream}-byte {codec} round trip differs")
        kernel = "pack" if stream < 65536 else "packroute"
        if counts["bigsort"] < 1 or counts[kernel] < 1:
            raise AssertionError(f"a kernel was not launched: {counts}")
        small_counts = small_counts or counts
        reset_counts()
        os.environ["DENSITY_TPU_SORT"] = "bitonic"
        try:
            other = container.compress(data, codec, stream, device=dev)
        finally:
            del os.environ["DENSITY_TPU_SORT"]
        bcounts = read_counts()
        if other != blob or bcounts["bitonic"] < 1:
            raise AssertionError(f"DENSITY_TPU_SORT=bitonic changed the "
                                 f"{stream}-byte container ({bcounts})")
        also = ""
        if onehot:
            reset_counts()
            mode, layout.PACK_MODE = layout.PACK_MODE, "onehot"
            try:
                other = container.compress(data, codec, stream, device=dev)
            finally:
                layout.PACK_MODE = mode
            ocounts = read_counts()
            if other != blob or ocounts["pack"] < 1:
                raise AssertionError(f"pack mode onehot changed the "
                                     f"{stream}-byte container ({ocounts})")
            also = f" and pack mode onehot (launches {ocounts})"
        ratios[stream] = len(data) / len(blob)
        blobs[stream] = blob
        log(f"({tag}) {codec} {stream}-byte streams: {len(data)} bytes -> "
            f"{len(blob)} (ratio {ratios[stream]:.4f}) in {dt:.2f} s host "
            f"wall on the card ({plans[0]} copy-free and {plans[1]} masked "
            f"plans), equal to native.encode, round trip exact, byte-identical "
            f"under DENSITY_TPU_SORT=bitonic{also}; launches {counts}, under "
            f"bitonic {bcounts}")
    return ratios, small_counts, blobs


def phase_codec_edges(dev, rnd: bytes, codec: str):
    """(o, s) Random and mixed inputs (fixed point, copy blocks, ragged
    lengths) and one-shot streams, against the native encoder; decoded
    on both routes."""
    from density_tpu_torch import api, container, native
    from density_tpu_torch.parallel import sharding
    tag = TAGS[codec]["edges"]
    rng = np.random.default_rng(2)
    text = corpus_bytes(1 << 20)
    mixed = b"".join(text[i:i + 65536] + rng.integers(
        0, 256, 65536, dtype=np.uint8).tobytes()
        for i in range(0, 1 << 20, 131072)) + b"xyz"
    for name, data in (("random", rnd), ("mixed", mixed)):
        blob = container.compress(data, codec, STREAM, device=dev)
        parts = payloads(blob)
        if parts != native.encode_many(codec, stream_chunks(data, STREAM)):
            raise AssertionError(f"{name}: {codec} streams differ")
        if container.decompress(blob, device=dev) != data:
            raise AssertionError(f"{name}: round trip differs")
        if b"".join(sharding.decode_streams(parts, None, dev,
                                            codec)) != data:
            raise AssertionError(f"{name}: device decode differs")
        log(f"({tag}) {codec} {name}: {len(data)} bytes -> {len(blob)}, "
            f"equal to native.encode, round trip exact on the container's "
            f"route and on the device")
    msgs = [text[7 * n:8 * n] for n in (0, 1, 63, 64, 127, 128, 1000, 16384,
                                        32771)]
    msgs.append(rnd[:32 << 10])
    for msg in msgs:
        enc = api.encode_raw(msg, codec, device=dev)
        if enc != api.encode_raw(msg, codec, backend="native"):
            raise AssertionError(f"encode_raw of {len(msg)} bytes differs")
        if api.decode_raw(enc, codec, device=dev) != msg:
            raise AssertionError(f"decode_raw of {len(msg)} bytes differs")
    log(f"({tag}) {codec} encode_raw/decode_raw on the card: "
        f"{[len(m) for m in msgs]} bytes, equal to the native backend")


def time_sort_3(dev, chee, large_quads) -> None:
    """bigsort and bitonic at the 3-array 2-key shapes cheetah and lion
    make (the resolve at S=38 x 65536, the planner on one 2^22-quad
    stream), with kernel launches per sort, the bound, and the library
    call beside them: `torch.sort` of the two keys packed into one int64,
    then a gather of the carried array."""
    import torch
    from density_tpu_torch.kernels import bigsort, bitonic
    for what, arrs in (("resolve", resolve_sort_inputs(chee["dargs"],
                                                       "cheetah")),
                       ("planner", planner_sort_inputs(large_quads))):
        S, N = arrs[0].shape

        def library():
            packed = (arrs[0].long() << 32) | (arrs[1].long() + 2**31)
            _, idx = torch.sort(packed, dim=1)
            return torch.gather(arrs[2], 1, idx)
        lib_ms = device_ms(library)
        for name, mod in (("bigsort", bigsort), ("bitonic", bitonic)):
            ms, n = device_profile(lambda: mod.sort(*arrs, n_keys=2))
            log_row(name, dict(
                ms=ms, plain_ms=None, library_ms=lib_ms,
                bound=sort_bound(S, N, 3),
                shape=f"cheetah {what}: S={S} N={N} 2 keys 3 arrays; {n:g} "
                      "kernel launches per sort in the trace; library = "
                      "torch.sort of the packed int64 keys + gather"))


def time_lion_packs(lion_in, lion_small) -> None:
    """packroute at S=38 x 65536 and pack at S=622 x 4096 on lion's real
    plans (q=16, flag_bits=3), with kernel launches per call."""
    from density_tpu_torch.kernels import pack, packroute
    for name, mod, inputs in (("packroute", packroute, lion_in),
                              ("pack", pack, lion_small)):
        args = inputs["pack_in"]
        S, N = args[0].shape
        ms, n = device_profile(lambda: mod.pack(*args, **LION))
        log_row(name, dict(
            ms=ms,
            plain_ms=device_ms(lambda: mod.pack_plain(*args, **LION),
                               iters=3),
            library_ms=None, bound=pack_bound(S, N, 16, 3),
            shape=f"lion's plan: S={S} N={N} q=16 flag_bits=3; {n:g} kernel "
                  "launch per call"))


# the MTF kernel's depth K: its caller, and the scan it takes the operands
# of (the planner's module attribute, wrapped while it plans)
MTF_SCANS = {5: ("lion", "mtf_depths_sorted"),
             2: ("cheetah", "mtf2_depths_sorted")}


def mtf_plan_inputs(K: int, quads, nbytes):
    """The MTF-K scan's operands (first, values, valid) as the copy-free
    plan of `quads` of MTF_SCANS[K]'s codec hands them over."""
    import importlib
    codec, name = MTF_SCANS[K]
    mod = importlib.import_module(f"density_tpu_torch.codecs.{codec}")
    seen, scan = [], getattr(mod, name)
    setattr(mod, name, lambda *a: seen.append(a[:3]) or scan(*a))
    try:
        mod.plan_fast(quads, nbytes)
    finally:
        setattr(mod, name, scan)
    (ops,) = seen
    return ops


def mtf_shapes(dev, data: bytes, K: int, codec_in, large_quads) -> dict:
    """The MTF-K scan's operands at its codec's plan shapes: the corpus's
    38 full 256 KiB streams, its tail (S=1 x 65536) and the corpus as one
    2^22-quad row (the planner's 2-key branch)."""
    import torch
    from density_tpu_torch.engine import layout
    from density_tpu_torch.parallel import sharding
    tail = data[len(data) // STREAM * STREAM:]
    tail_quads, tail_nb = sharding.stage_encode(
        np.frombuffer(tail, np.uint8), len(tail), 1,
        layout.bucket_bytes(STREAM, 64), STREAM, dev)
    big_nb = torch.tensor([len(data)], dtype=torch.int32, device=dev)
    return {f"S={q.shape[0]} n={q.shape[1]}": mtf_plan_inputs(K, q, nb)
            for q, nb in ((codec_in["quads"], codec_in["nbytes"]),
                          (tail_quads, tail_nb), (large_quads, big_nb))}


def mtf_plain(K: int):
    """The plain versions the MTF-K kernel is held to: the K-slot scan,
    and at K=2 the planners' MTF-2 op chain too."""
    from functools import partial
    from density_tpu_torch.kernels import mtf
    plain = [partial(mtf.depths_plain, K=K)]
    return plain + [mtf.mtf2_plain] if K == 2 else plain


def parity_mtf(shapes: dict, K: int) -> int:
    """(b) The MTF-K kernel against its plain versions on its codec's
    plan operands; returns the largest error."""
    import torch
    from density_tpu_torch.kernels import mtf
    err = 0
    for ops in shapes.values():
        got = mtf.depths(*ops, K)
        torch.cuda.synchronize()
        for plain in mtf_plain(K):
            err = max(err, max_abs_err(got, plain(*ops)))
    log(f"(b) mtf at K={K}, {MTF_SCANS[K][0]}'s plan shapes "
        f"{sorted(shapes)}: max_abs_err {err}")
    return err


def time_mtf(shapes: dict, K: int) -> dict:
    """(f) The MTF-K kernel at its codec's plan shapes with its kernel
    launches per scan, beside its bound (each element's two flags and
    value read and its depth written once) and its plain version (at
    K=2 the planners' op chain). Returns the row of the 38-stream
    shape."""
    from density_tpu_torch.kernels import mtf
    rows = {}
    plain = mtf_plain(K)[-1]
    for shape, ops in shapes.items():
        n_el = ops[1].numel()
        ms, n = device_profile(lambda: mtf.depths(*ops, K))
        if round(n) != 1:
            raise AssertionError(f"mtf made {n:g} kernel launches a scan")
        rows[shape] = dict(
            ms=ms, plain_ms=device_ms(lambda: plain(*ops), iters=3),
            library_ms=None, bound=bound_ms(10 * n_el, 0),
            shape=f"K={K}, {MTF_SCANS[K][0]}'s plan: {shape}; {n:g} "
                  "kernel launch per scan")
        log_row("mtf" if K == 5 else "mtf2", rows[shape])
    return next(iter(rows.values()))


def fsm_shapes(dev, data: bytes, paths: dict) -> dict:
    """The FSM step's operands (bits, nbytes, block) at the bulk cells'
    shapes: the incompressible bits of lion's and cheetah's copy-free
    plans of the corpus's 38 full 256 KiB streams (4096 and 2048 blocks
    a stream) and of lion's plan of its tail (S=1 x 4096)."""
    from density_tpu_torch.codecs import cheetah, lion
    from density_tpu_torch.engine import layout
    from density_tpu_torch.parallel import sharding
    tail = data[len(data) // STREAM * STREAM:]
    tail_in = dict(zip(("quads", "nbytes"), sharding.stage_encode(
        np.frombuffer(tail, np.uint8), len(tail), 1,
        layout.bucket_bytes(STREAM, 64), STREAM, dev)))
    shapes = {}
    for name, mod, inputs in (("lion", lion, paths["lion"][0]),
                              ("cheetah", cheetah, paths["cheetah"][0]),
                              ("lion's tail", lion, tail_in)):
        bits = mod.plan_fast(inputs["quads"], inputs["nbytes"])[5]
        S, nb = bits.shape
        shapes[f"{name}: S={S} nb={nb}"] = (
            bits.contiguous(), inputs["nbytes"], mod.PIPELINE.BLOCK)
    return shapes


def parity_fsm(shapes: dict) -> int:
    """(b) The FSM step on the card against its plain replay on the host,
    copy set and flags, against a copy set of zeros and against the
    replay's own; returns the largest error."""
    import torch
    from density_tpu_torch.kernels import fsm
    err = 0
    for bits, nbytes, block in shapes.values():
        host = (bits.cpu(), nbytes.cpu())
        zeros = torch.zeros_like(host[0])
        want = fsm.step_plain(*host, block, zeros)[0]
        for prev in (zeros, want):
            want_flags = fsm.step_plain(*host, block, prev)[1]
            got, flags = fsm.step(bits, nbytes, block, prev.to(bits.device))
            torch.cuda.synchronize()
            err = max(err, max_abs_err((got.cpu(), flags.cpu()),
                                       (want, want_flags)))
    log(f"(b) fsm at the bulk plans' shapes {sorted(shapes)}: max_abs_err "
        f"{err}")
    return err


def time_fsm(shapes: dict) -> dict:
    """(f) The FSM step at (b)'s shapes with its kernel launches per step,
    beside its bound (the bits and the last copy set read, the new set
    and nbytes written or read once) and the host milliseconds of the
    plain replay (`kernels/fsm.py::step_plain` on host copies: the step
    the fixed point took before the kernel). Returns the row of lion's
    38-stream shape."""
    import torch
    from density_tpu_torch.kernels import fsm
    rows = {}
    for shape, (bits, nbytes, block) in shapes.items():
        prev = torch.zeros_like(bits)
        ms, n = device_profile(lambda: fsm.step(bits, nbytes, block, prev))
        if round(n) != 1:
            raise AssertionError(f"fsm made {n:g} kernel launches a step")
        host = [x.cpu() for x in (bits, nbytes, prev)]
        plain = []
        for _ in range(3):
            t = time.perf_counter()
            fsm.step_plain(host[0], host[1], block, host[2])
            plain.append((time.perf_counter() - t) * 1e3)
        rows[shape] = dict(
            ms=ms, plain_ms=min(plain), library_ms=None,
            bound=bound_ms(3 * bits.numel() + 4 * nbytes.numel(), 0),
            shape=f"{shape} (block {block}); {n:g} kernel launch per step; "
                  f"plain = host ms of the replay")
        log_row("fsm", rows[shape])
    return next(iter(rows.values()))


def time_codec(dev, codec, inputs, conv_dargs, conv_data, data,
               blob) -> None:
    """A codec's device-resident encode (the corpus at 256 KiB) and decode
    (the converging input of (l) or (q)), the host pool's decode of the
    corpus, host syncs and device time and kernel launches per call, and
    one profiler trace of each."""
    from density_tpu_torch import native
    from density_tpu_torch.engine import layout
    from density_tpu_torch.parallel import sharding
    quads, nbytes = inputs["quads"], inputs["nbytes"]
    pipe = sharding.codec_module(codec).PIPELINE

    def enc():
        return layout.run_encode(pipe, quads, nbytes)

    def dec():
        return sharding.decode_batch(*conv_dargs, codec)
    if not enc()[2]:
        raise AssertionError(f"the timed {codec} encode did not converge")
    for what, fn, n in (("encode (corpus)", enc, int(nbytes.sum())),
                        ("decode (alphabet input)", dec, len(conv_data))):
        runs = sorted(timed_ms(fn, iters=5) for _ in range(REPEATS))
        med = statistics.median(runs)
        ms, launches = device_profile(fn, iters=5)
        log(f"(f) {codec} device-resident {what} S={quads.shape[0]} "
            f"N={quads.shape[1]}: median {med:.3f} ms = {n / med / 1e6:.3f} "
            f"GB/s (range {runs[0]:.3f}-{runs[-1]:.3f} ms, {REPEATS} windows "
            f"of 5 calls); device {ms:.4f} ms and {launches:g} kernel "
            f"launches per call; host syncs per call {host_syncs(fn)}")
    streams = payloads(blob)
    n = len(data)
    caps = [min(STREAM, n - i) for i in range(0, n, STREAM)]
    runs = []
    for _ in range(REPEATS):
        t = time.perf_counter()
        native.decode_many(codec, streams, caps)
        runs.append((time.perf_counter() - t) * 1e3)
    runs.sort()
    med = statistics.median(runs)
    log(f"(f) {codec} host pool decode of the corpus ({len(streams)} "
        f"streams, {native.N_THREADS} threads): median {med:.3f} ms = "
        f"{n / med / 1e6:.3f} GB/s (range {runs[0]:.3f}-{runs[-1]:.3f} ms, "
        f"{REPEATS} calls)")
    phase_profile({f"{codec}_encode": enc, f"{codec}_decode": dec})


# -------------------------------------- shares, processes, stats, sessions

RANK_TIMEOUT = 300  # seconds for each rank of phase (u)
RANK_INPUTS = ("corpus", "alphabet", "vocab")
PATH_KERNELS = {"chameleon": ("bigsort", "packroute", "unpack"),
                "cheetah": ("bigsort", "packroute", "mtf"),
                "lion": ("bigsort", "packroute", "mtf")}


def vocab_input(n_streams: int = 4, stream_size: int = 2048) -> bytes:
    """The JAX package's multi-chip recipe (`__graft_entry__.py`, the
    dry run's input at 2 devices): quads from 97 seeded values, a low
    predicted share, so cheetah and lion decode on the device."""
    rng = np.random.default_rng(7)
    vocab = rng.integers(1, 1 << 32, 97, dtype=np.uint64).astype(np.uint32)
    qd = vocab[rng.integers(0, 97, (n_streams * stream_size) // 4)]
    return qd.astype("<u4").tobytes()[:n_streams * stream_size - 123]


def rank_inputs(seed: int) -> dict:
    """Phase (u)'s inputs by name: (data, stream size)."""
    return {"corpus": (corpus_bytes(), STREAM),
            "alphabet": (alphabet_input(seed), STREAM),
            "vocab": (vocab_input(), 2048)}


def wall_ms(fn) -> float:
    """Host milliseconds of one call that ends in a host copy (container
    bytes), the card synchronised after it."""
    import torch
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


SHARE_LISTS = (2, 4)  # shares on the one card of phase (t)
SHARE_REPEATS = 10  # round trips of each container in shares (t)
# The ratios of the 2-share wall to the one-device wall when one host
# thread ran the shares in turn (two calls on an H100 80GB HBM3, 700 W;
# PERF.md section 6)
IN_TURN_RATIOS = {"chameleon": ("0.951-1.011x", "1.106-1.121x"),
              "cheetah": ("1.067-1.161x", "1.035-1.047x"),
              "lion": ("0.928-0.968x", "0.927-1.051x")}


def overlap(spans, wall_s: float) -> float:
    """The share of `wall_s` in which at least two of `spans` were in
    flight."""
    events = sorted([(a, 1) for a, _ in spans] + [(b, -1) for _, b in spans])
    depth, both = 0, 0.0
    for (t, d), (t_next, _) in zip(events, events[1:]):
        depth += d
        if depth >= 2:
            both += t_next - t
    return both / wall_s


@contextlib.contextmanager
def spanned():
    """One profiler session around a series of calls of the port; once it
    has ended, the list it yields holds (overlap share, tasks) of each
    call in order, read from the port's spans: a call's wall is its root
    `density.container.*` span, its share tasks the
    `density.sharding.share` spans inside it. The session records the
    host alone, as the benchmark's does with the card besides."""
    from torch.profiler import ProfilerActivity, profile
    calls = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield calls
    events = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
              for e in prof.events() if e.name.startswith("density.")]
    shares = [(a, b) for n, a, b in events if n == "density.sharding.share"]
    for a, b in sorted((a, b) for n, a, b in events
                       if n.startswith("density.container.")):
        mine = [(x, y) for x, y in shares if a <= x and y <= b]
        calls.append((overlap(mine, b - a), len(mine)))


def one_device_counts(seed: int = 0) -> dict:
    """Host syncs (CUDA's sync debug mode) and kernel launches of one
    compress and one decompress on one card, for each codec: the corpus
    in 256 KiB streams (cheetah and lion decompress it on the host pool)
    and, for cheetah and lion, phase l's seeded input (the device route).
    Uses only what the tree before the shares' workers has too, so
    `--parent` runs it there."""
    import torch
    from density_tpu_torch import container
    from density_tpu_torch.kernels import _build
    _build.build()
    dev = torch.device("cuda")
    inputs = {"corpus": corpus_bytes(), "alphabet": alphabet_input(seed)}
    out = {}
    for codec in ("chameleon", "cheetah", "lion"):
        for name, data in inputs.items():
            if codec == "chameleon" and name == "alphabet":
                continue
            blob = container.compress(data, codec, STREAM, device=dev)
            for what, fn in (
                    ("compress", lambda: container.compress(
                        data, codec, STREAM, device=dev)),
                    ("decompress", lambda: container.decompress(
                        blob, device=dev))):
                fn()
                torch.cuda.synchronize()
                reset_counts()
                fn()
                torch.cuda.synchronize()
                out[f"{codec} {name} {what}"] = dict(
                    syncs=host_syncs(fn), launches=read_counts())
    return out


COUNT_WORKER = """
import json, os, runpy, sys
sys.path.insert(0, os.getcwd())
smoke = runpy.run_path(os.environ["SMOKE_SCRIPT"])
print(json.dumps(smoke["one_device_counts"](int(os.environ["SMOKE_SEED"]))))
"""


def parent_counts(parent: str, seed: int) -> dict:
    """`one_device_counts` run on the tree in `parent` (its package, its
    own kernel build), in a process of its own."""
    env = dict(os.environ, SMOKE_SCRIPT=os.path.abspath(__file__),
               SMOKE_SEED=str(seed))
    p = subprocess.run([sys.executable, "-c", COUNT_WORKER], cwd=parent,
                       env=env, capture_output=True, text=True,
                       timeout=RANK_TIMEOUT)
    if p.returncode != 0:
        raise AssertionError(f"(t) the parent's counts failed "
                             f"({p.returncode}): {p.stderr[-3000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def shares_round_trip(data: bytes, codec: str, stream: int, devs: list,
                      want: bytes, route, where: str) -> None:
    """Compresses `data` in the shares of `devs`, which must give `want`,
    and decompresses that container, which must give `data`; with
    `route` = (input, container), that container too, which must give
    its input. Raises, naming `where`, at the first that differs."""
    from density_tpu_torch import container
    got = container.compress(data, codec, stream, device=devs)
    if got != want:
        raise AssertionError(f"(t) {where}: the container differs from "
                             "one device's")
    if container.decompress(got, device=devs) != data:
        raise AssertionError(f"(t) {where}: round trip differs")
    if route is not None and container.decompress(
            route[1], device=devs) != route[0]:
        raise AssertionError(f"(t) {where}: the device route differs")


def phase_shares(dev, data: bytes, blobs: dict, conv: dict,
                 small_blob: bytes, mib_blob: bytes, parent: str | None,
                 seed: int) -> dict:
    """(t) Shares on the card, run at once (a worker thread and a CUDA
    stream each): each codec's corpus in 256 KiB streams in 2 and 4
    shares (and over every card where there are several), compressed and
    decompressed SHARE_REPEATS times untraced and as many times more in a
    profiler session, each container equal to its one-device phase's
    (c, k, p) and each round trip exact; cheetah and
    lion also decoded on the device route through the shares (phase l's
    and q's input); chameleon in 16 KiB streams (pack) and under
    DENSITY_TPU_SORT=bitonic in 2 shares, and in 1 MiB streams in 4.
    Every kernel of a path is launched at least once a share. Prints the
    share of each call's wall in which two or more share tasks were in
    flight (each task's `density.sharding.share` span), which must be
    above 0 for every 2-share compress; the host syncs and launches per
    call; and the walls on one device and in 2 and 4 shares, in turns.
    With `parent`, the one-device counts must equal that tree's. Returns
    the 2-share
    counts by codec."""
    import torch
    from density_tpu_torch import container
    lists = {f"{k} shares": [dev] * k for k in SHARE_LISTS}
    if torch.cuda.device_count() > 1:
        lists["every card"] = [torch.device("cuda", i)
                               for i in range(torch.cuda.device_count())]
    counts = {}
    for codec, blob in blobs.items():
        for what, devs in lists.items():
            route = None if codec == "chameleon" else conv[codec][:2]
            for rep in range(SHARE_REPEATS):  # untraced, as users call
                reset_counts()
                shares_round_trip(data, codec, STREAM, devs, blob, route,
                                  f"{codec} in {what}, round {rep}")
                if rep == 0:
                    c = read_counts()
            # the overlaps, from the spans of as many rounds more; a
            # round's calls: compress, decompress and, for cheetah and
            # lion, the device route's decompress, whose overlap is kept
            with spanned() as calls:
                for rep in range(SHARE_REPEATS, 2 * SHARE_REPEATS):
                    shares_round_trip(data, codec, STREAM, devs, blob, route,
                                      f"{codec} in {what}, round {rep}")
            per_round = 2 if codec == "chameleon" else 3
            overlaps = {"compress": [], "decompress": []}
            for rep in range(SHARE_REPEATS):
                (ov, n_c), *_, (ov_d, n_d) = calls[rep * per_round:
                                                   (rep + 1) * per_round]
                if ov <= 0 and len(devs) == 2:
                    raise AssertionError(f"(t) {codec} in {what}, traced "
                                         f"round {rep}: no two shares ran "
                                         "at once")
                overlaps["compress"].append(ov)
                overlaps["decompress"].append(ov_d)
            low = {k: c[k] for k in PATH_KERNELS[codec] if c[k] < len(devs)}
            if low:
                raise AssertionError(f"(t) {codec} in {what}: kernels "
                                     "launched fewer times than shares: "
                                     f"{low}")
            counts.setdefault(codec, c)
            per_share = {k: v / len(devs) for k, v in c.items() if v}
            dec_what = ("decompress" if codec == "chameleon" else
                        "device-route decompress of the alphabet input")
            log(f"(t) {codec} corpus in {what} ({len(devs)} devices, "
                f"{n_c} compress tasks, {n_d} decompress tasks): "
                f"{2 * SHARE_REPEATS} round trips ({SHARE_REPEATS} traced), "
                f"every container equal to one device's, every round trip "
                f"exact; two or more tasks in flight for "
                f"{fmt_range(overlaps['compress'])} of the "
                f"compress wall and {fmt_range(overlaps['decompress'])} of "
                f"the {dec_what} wall; launches of the first round {c}, "
                f"{per_share} a share")
        share_walls(dev, data, codec, blob)
    share_options(dev, data, blobs["chameleon"], small_blob, mib_blob)
    mine = one_device_counts(seed)
    for name, c in mine.items():
        log(f"(t) one device, {name}: {c['syncs']} host syncs, launches "
            f"{c['launches']}")
    for k in SHARE_LISTS:
        devs = [dev] * k
        for codec, blob in blobs.items():
            held = []
            syncs = (host_syncs(lambda: container.compress(
                data, codec, STREAM, device=devs), held), host_syncs(
                lambda: container.decompress(
                    blob if codec == "chameleon" else conv[codec][1],
                    device=devs), held))
            if held:
                raise AssertionError(f"(t) {codec} in {k} shares: host "
                                     "syncs while a worker held the host's "
                                     f"turn, at {sorted(set(held))}")
            log(f"(t) {codec} in {k} shares: host syncs per compress "
                f"{syncs[0]}, per "
                f"{'' if codec == 'chameleon' else 'device-route '}"
                f"decompress {syncs[1]} (the workers' warnings counted), "
                f"none while a worker held the host's turn")
    if parent:
        theirs = parent_counts(parent, seed)
        if theirs != mine:
            raise AssertionError(f"(t) one-device counts differ from the "
                                 f"parent's: {theirs} != {mine}")
        log(f"(t) one-device host syncs and launches equal those of the "
            f"tree in {parent} ({len(mine)} calls)")
    return counts


def fmt_range(xs) -> str:
    return f"{min(xs):.3f}-{max(xs):.3f} (mean {np.mean(xs):.3f})"


def share_walls(dev, data: bytes, codec: str, blob: bytes) -> None:
    """Host walls of compress and decompress of the corpus on one device,
    in 2 and in 4 shares, in turns (one, two, four, four, two, one)."""
    from density_tpu_torch import container
    runs = {1: [], 2: [], 4: []}
    for k in (1, 2, 4, 4, 2, 1):
        devs = [dev] * k
        runs[k].append((
            wall_ms(lambda: container.compress(data, codec, STREAM,
                                               device=devs)),
            wall_ms(lambda: container.decompress(blob, device=devs))))
    (e1, d1), (e2, d2), (e4, d4) = (np.mean(runs[k], axis=0)
                                    for k in (1, 2, 4))
    log(f"(t) {codec} host wall, mean of 2 turns (one, two, four, four, "
        f"two, one): compress {e1:.3f} ms on one device, {e2:.3f} ms in 2 "
        f"shares ({e2 / e1:.3f}x; in turn {IN_TURN_RATIOS[codec][0]}), "
        f"{e4:.3f} ms in 4 ({e4 / e1:.3f}x); decompress {d1:.3f}, "
        f"{d2:.3f} ({d2 / d1:.3f}x; in turn {IN_TURN_RATIOS[codec][1]}) "
        f"and {d4:.3f} ms ({d4 / d1:.3f}x)")


def share_options(dev, data: bytes, main_blob: bytes, small_blob: bytes,
                  mib_blob: bytes) -> None:
    """Chameleon in 2 shares in 16 KiB streams (the pack kernel) and in
    256 KiB streams under DENSITY_TPU_SORT=bitonic (the bitonic kernel),
    and in 4 shares of 1 MiB streams (3 streams a share: packroute with
    several clusters a stream, whose launches on the shares' streams run
    in launch order): each container equal to one device's, the kernel
    launched at least once a share, the tasks in flight at once: one
    call untraced, then one in a profiler session for the overlaps."""
    for what, stream, want, kernel, devs in (
            ("16 KiB streams", SMALL_STREAMS[1], small_blob, "pack",
             [dev] * 2),
            ("DENSITY_TPU_SORT=bitonic", STREAM, main_blob, "bitonic",
             [dev] * 2),
            ("1 MiB streams", LARGE_STREAMS[0], mib_blob, "packroute",
             [dev] * 4)):
        where = f"chameleon in {len(devs)} shares, {what}"
        reset_counts()
        if kernel == "bitonic":
            os.environ["DENSITY_TPU_SORT"] = "bitonic"
        try:
            shares_round_trip(data, "chameleon", stream, devs, want, None,
                              where)
            c = read_counts()
            with spanned() as calls:
                shares_round_trip(data, "chameleon", stream, devs, want,
                                  None, f"{where}, traced")
        finally:
            os.environ.pop("DENSITY_TPU_SORT", None)
        (ov, n), (ov_d, _) = calls
        if c[kernel] < len(devs) or ov <= 0:
            raise AssertionError(f"(t) chameleon in {len(devs)} shares, "
                                 f"{what}: {kernel} launched {c[kernel]} "
                                 f"times, overlap {ov}")
        log(f"(t) chameleon in {len(devs)} shares, {what}: container equal "
            f"to one "
            f"device's, round trip exact; {n} tasks, two or more in flight "
            f"for {ov:.3f} of the compress wall and {ov_d:.3f} of the "
            f"decompress wall; launches {c}")


RANK_WORKER = """
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke
chip_smoke.rank_worker(os.environ["SMOKE_OUT"], int(os.environ["SMOKE_SEED"]))
"""


def rank_worker(out_dir: str, seed: int) -> None:
    """One rank of phase (u): `distributed_init` from torchrun's
    environment, every input of `rank_inputs` compressed and decompressed
    through `container` on this rank's default device, each container
    written to `out_dir`; prints this rank's launches as JSON."""
    import torch
    from density_tpu_torch import container
    from density_tpu_torch.parallel import mesh
    mesh.distributed_init()
    rank = mesh.process_index()
    if mesh.process_count() != 2:
        raise AssertionError("not a 2-process group")
    reset_counts()
    for name, (data, stream) in rank_inputs(seed).items():
        for codec in ("chameleon", "cheetah", "lion"):
            blob = container.compress(data, codec, stream)
            if container.decompress(blob) != data:
                raise AssertionError(f"rank {rank}: {codec} {name} round "
                                     "trip differs")
            with open(os.path.join(out_dir, f"{name}-{codec}-{rank}"),
                      "wb") as f:
                f.write(blob)
    torch.cuda.synchronize()
    print(json.dumps({"rank": rank, "device": str(mesh.default_devices()[0]),
                      "launches": read_counts()}), flush=True)
    torch.distributed.destroy_process_group()


def phase_processes(dev, seed: int, blobs: dict) -> None:
    """(u) Two `torch.distributed` ranks (gloo, torchrun's environment,
    both on `cuda:0` with one card) compress and decompress the corpus in
    256 KiB streams, phase l's seeded input and the JAX package's 97-value
    multi-chip input, for the three codecs. Every rank's container must
    equal the one-process one in `blobs` ((name, codec) -> container); a
    rank that fails or outlasts RANK_TIMEOUT fails the phase, and both are
    killed. The ranks' containers go to a scratch directory under DIR,
    removed at the end."""
    import shutil
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="ranks-", dir=OUT_DIR)
    try:
        _run_ranks(out_dir, seed, blobs)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _run_ranks(out_dir: str, seed: int, blobs: dict) -> None:
    """Phase (u)'s two ranks, writing to `out_dir`; see
    `phase_processes`."""
    import socket
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    t = time.time()
    try:
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), SMOKE_OUT=out_dir,
                       SMOKE_SEED=str(seed))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_WORKER], cwd=here, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        reports = []
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=RANK_TIMEOUT)
            if p.returncode != 0:
                raise AssertionError(f"(u) rank {rank} failed "
                                     f"({p.returncode}): {err[-3000:]}")
            reports.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    dt = time.time() - t
    for (name, codec), want in blobs.items():
        for rank in range(2):
            with open(os.path.join(out_dir, f"{name}-{codec}-{rank}"),
                      "rb") as f:
                if f.read() != want:
                    raise AssertionError(f"(u) rank {rank}: {codec} {name} "
                                         "differs from one process's")
    for r in reports:
        low = [k for k in ("bigsort", "packroute", "unpack")
               if r["launches"][k] < 1]
        if low:
            raise AssertionError(f"(u) rank {r['rank']} launched no {low}")
    log(f"(u) 2 ranks (gloo) in {dt:.1f} s wall, on "
        f"{[r['device'] for r in reports]}: {len(blobs)} containers "
        f"({', '.join(RANK_INPUTS)} x 3 codecs) equal on both ranks and to "
        f"one process's, every round trip exact; launches "
        f"{[r['launches'] for r in reports]}")


def phase_stats(dev, data: bytes, one_blobs: dict, big_blobs: dict) -> None:
    """(v) `encode_stats` on the card for the three codecs, on one 256 KiB
    stream and on the corpus as one 2^22-quad stream, equal to
    `stream_stats` of the card's encoded stream (stream 0 of phases c, k
    and p; the 32 MiB containers of phases j, n and r), bigsort counted;
    on the long stream its host wall beside one copy-free planner pass."""
    import torch
    from density_tpu_torch import stats
    from density_tpu_torch.engine import layout
    from density_tpu_torch.parallel import sharding
    for codec in ("chameleon", "cheetah", "lion"):
        pipe = sharding.codec_module(codec).PIPELINE
        for what, chunk, blob in (
                ("256 KiB stream", data[:STREAM], one_blobs[codec]),
                ("corpus (2^22 quads)", data, big_blobs[codec])):
            stream = payloads(blob)[0]
            reset_counts()
            t = time.perf_counter()
            got = stats.encode_stats(codec, chunk, device=dev)
            ms = (time.perf_counter() - t) * 1e3
            launches = read_counts()["bigsort"]
            want = stats.stream_stats(codec, chunk, stream)
            if got != want:
                raise AssertionError(f"(v) {codec} {what}: encode_stats "
                                     f"{got} != stream_stats {want}")
            if launches < 1:
                raise AssertionError(f"(v) {codec} {what}: no bigsort launch")
            plan = ""
            if len(chunk) > STREAM:
                padded = np.zeros((1, layout.bucket_bytes(
                    len(chunk), pipe.BLOCK)), np.uint8)
                padded[0, :len(chunk)] = np.frombuffer(chunk, np.uint8)
                quads = layout.stage_quads(padded, dev)
                nbytes = torch.tensor([len(chunk)], dtype=torch.int32,
                                      device=dev)
                bits = pipe.plan_fast(quads, nbytes)[5]  # warm
                plan_ms = min(wall_ms(lambda: pipe.plan_fast(quads, nbytes))
                              for _ in range(3))
                stage_ms = min(wall_ms(lambda: layout.stage_quads(padded,
                                                                  dev))
                               for _ in range(3))
                zeros = torch.zeros_like(bits)
                fsm_ms = min(wall_ms(lambda: layout.step_fsm(
                    bits, nbytes, pipe.BLOCK, zeros)) for _ in range(3))
                t = time.perf_counter()
                stats.encode_stats(codec, chunk, device=dev)
                warm = (time.perf_counter() - t) * 1e3
                plan = (f"; warm {warm:.3f} ms against {plan_ms:.3f} ms for "
                        f"one copy-free plan of the staged row "
                        f"({warm / plan_ms:.2f} plans), {stage_ms:.3f} ms "
                        f"to stage it and {fsm_ms:.3f} ms for one step "
                        f"of the protection FSM (a launch and the read of "
                        f"its flags)")
            log(f"(v) {codec} encode_stats, {what}: equal to stream_stats "
                f"of the card's stream (ratio {want.ratio:.4f}, "
                f"{want.copy_blocks} copy blocks of {want.n_blocks}), "
                f"bigsort launches {launches}, first call {ms:.3f} ms host "
                f"wall{plan}")


def phase_sessions(data: bytes) -> None:
    """(w) Chunked sessions of the corpus in uneven seeded chunks (1 byte
    to 1 MiB) equal to `native.encode` for each codec, decoded back in
    other chunks; an LZ4 round trip of the corpus."""
    from density_tpu_torch import native
    from density_tpu_torch.stream import StreamDecoder, StreamEncoder
    rng = np.random.default_rng(9)

    def chunks(buf):
        out, p = [], 0
        while p < len(buf):
            n = int(rng.choice([1, 7, 4095, 65536, 1 << 20, 300001]))
            out.append(buf[p:p + n])
            p += n
        return out
    for codec in ("chameleon", "cheetah", "lion"):
        t = time.perf_counter()
        with StreamEncoder(codec) as enc:
            parts = chunks(data)
            got = b"".join(enc.update(c) for c in parts) + enc.finish()
        t_enc = time.perf_counter() - t
        if got != native.encode(codec, data):
            raise AssertionError(f"(w) {codec} session differs from "
                                 "native.encode")
        with StreamDecoder(codec) as dec:
            back = b"".join(dec.update(c) for c in chunks(got)) + dec.finish()
        if back != data:
            raise AssertionError(f"(w) {codec} session decode differs")
        log(f"(w) {codec} session: {len(parts)} chunks, {len(got)} bytes, "
            f"equal to native.encode, decoded back exact; encode "
            f"{len(data) / t_enc / 1e6:.3f} MB/s host")
    t = time.perf_counter()
    lz = native.lz4_compress(data)
    t_lz = time.perf_counter() - t
    if native.lz4_decompress(lz, len(data)) != data:
        raise AssertionError("(w) lz4 round trip differs")
    log(f"(w) lz4: {len(data)} -> {len(lz)} bytes (ratio "
        f"{len(data) / len(lz):.4f}), round trip exact; compress "
        f"{len(data) / t_lz / 1e6:.3f} MB/s host")



# ------------------------------------------------- the fault surface (x)

FAULT_STREAM = 4096  # bytes a stream of the mutated containers
FAULT_SEEDS = 8  # seeded inputs a codec, each mutated about 30 ways
_HDR = struct.Struct("<4sBBHQII")  # the DTPU v1 header


def fault_input(seed: int) -> bytes:
    """The input of `seed` that phase (x) mutates: three 4 KiB streams and
    a ragged tail of 1001-1007 bytes. Even seeds: text with repeats
    around a random section; odd seeds: quads from 97 seeded values (the
    JAX package's multi-chip recipe), whose low predicted share keeps
    cheetah's decode on the device."""
    rng = np.random.default_rng(seed)
    n = 3 * FAULT_STREAM + 1001 + 2 * (seed // 2 % 4)
    if seed % 2:
        vocab = rng.integers(1, 1 << 32, 97, dtype=np.uint64).astype(
            np.uint32)
        return vocab[rng.integers(0, 97, n // 4 + 1)].astype(
            "<u4").tobytes()[:n]
    words = [b"the quick brown fox ", b"jumps over ", b"lazy dog ",
             b"density ", b"codec\n"]
    text = b"".join(words[i] for i in rng.integers(0, 5, n // 4))
    noise = rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
    return (text[:5000] + noise + text[5000:])[:n]


def zero_stream_headers(codec_id: int, original_len: int,
                        stream_size: int) -> list:
    """Headers of no streams and no payload, with the length given and
    with 0: [(name, container)]."""
    return [(f"0 streams, length {n}",
             _HDR.pack(b"DTPU", 1, codec_id, 0, n, stream_size, 0))
            for n in (original_len, 0)]


def mutations(blob: bytes, seed: int) -> list:
    """Seeded malformed variants of a container of several streams:
    [(name, container)]. Byte flips in each header field (magic, version,
    codec id, reserved, `original_len`, `stream_size`, stream count) and
    in the stream-length table; the other codec ids; lengths and counts
    rewritten; two table entries swapped; payload flips; cuts in the
    header, the table and the payload; appended bytes; two streams
    swapped with their lengths; the zero-stream headers."""
    rng = np.random.default_rng(1000 + seed)
    _, _, codec_id, _, original_len, stream_size, S = _HDR.unpack_from(blob)
    off = _HDR.size + 4 * S
    lengths = np.frombuffer(blob[_HDR.size:off], "<u4").astype(np.int64)
    ends = off + np.cumsum(lengths)
    streams = [blob[e - n:e] for e, n in zip(ends, lengths)]
    out = []

    def put(name, pos, new: bytes):
        b = bytearray(blob)
        b[pos:pos + len(new)] = new
        out.append((name, bytes(b)))

    def flip(name, lo, hi):
        pos = int(rng.integers(lo, hi))
        put(f"{name} flip @{pos}", pos,
            bytes([blob[pos] ^ int(rng.integers(1, 256))]))

    flip("magic", 0, 4)
    flip("version", 4, 5)
    flip("codec id", 5, 6)
    for cid in {0, 1, 2} - {codec_id}:
        put(f"codec id {cid}", 5, bytes([cid]))
    flip("reserved", 6, 8)
    for _ in range(3):
        flip("original_len", 8, 11)
    flip("original_len", 11, 16)
    tail = original_len - (S - 1) * stream_size
    for n in (original_len - 1, original_len + 1, original_len - tail):
        put(f"original_len {n}", 8, n.to_bytes(8, "little"))
    for _ in range(2):
        flip("stream_size", 16, 20)
    flip("stream count", 20, 24)
    for n in (S - 1, S + 1):
        put(f"stream count {n}", 20, n.to_bytes(4, "little"))
    for _ in range(2):
        flip("length table", _HDR.size, off)
    a, b = (int(i) for i in rng.choice(S, 2, replace=False))
    order = list(range(S))
    order[a], order[b] = b, a
    put(f"lengths {a}<->{b}", _HDR.size,
        lengths[order].astype("<u4").tobytes())
    for _ in range(4):
        flip("payload", off, len(blob))
    for lo, hi in ((1, _HDR.size), (_HDR.size, off), (off, len(blob))):
        cut = int(rng.integers(lo, hi))
        out.append((f"cut @{cut}", blob[:cut]))
    for k in (1, int(rng.integers(2, 64))):
        out.append((f"{k} bytes appended", blob + rng.integers(
            0, 256, k, dtype=np.uint8).tobytes()))
    out.append((f"streams {a}<->{b}", blob[:_HDR.size]
                + lengths[order].astype("<u4").tobytes()
                + b"".join(streams[i] for i in order)))
    return out + zero_stream_headers(codec_id, original_len, stream_size)


def adversarial_inputs() -> dict:
    """Compressible and incompressible sections whose lengths cross the
    protection FSM's boundaries (arming, decay, the halving every 16th
    block), and a long random run: the JAX package's
    `tests/test_fuzz.py::_adversarial_inputs`, case for case."""
    rng = random.Random(1234)
    cases = {}
    for trial in range(6):
        parts = []
        for k in range(rng.randint(6, 18)):
            n_blocks = rng.choice([1, 2, 3, 5, 15, 16, 17, 33])
            if k % 2 == trial % 2:
                parts.append(rng.randbytes(256 * n_blocks))
            else:
                parts.append(b"abcd" * (64 * n_blocks))
        cases[f"interleave{trial}"] = b"".join(parts)
    cases["long_random"] = random.Random(7).randbytes(256 * 80)
    return cases


def outcome(fn, *args, **kw):
    """("ok", bytes) or (the error's class name, None) of `fn(*args,
    **kw)`; an error other than the package's own or the header's
    `struct.error` propagates."""
    from density_tpu_torch.errors import DensityError
    try:
        return "ok", fn(*args, **kw)
    except (DensityError, struct.error) as e:
        return type(e).__name__, None



@contextlib.contextmanager
def device_route():
    """Every container decodes on the device route: the predicted-share
    cutoff raised, so the host pool serves none."""
    from density_tpu_torch.parallel import sharding
    cutoff = sharding.PREDICTED_DEVICE_CUTOFF
    sharding.PREDICTED_DEVICE_CUTOFF = float("inf")
    try:
        yield
    finally:
        sharding.PREDICTED_DEVICE_CUTOFF = cutoff


@contextlib.contextmanager
def device_encodes_only(what: str):
    """Fails if an encode inside handed a stream to the native encoder (a
    fixed point that did not converge): the bytes must be the device
    path's."""
    from density_tpu_torch import native
    calls = []
    one, many = native.encode, native.encode_many
    native.encode = lambda *a: calls.append(1) or one(*a)
    native.encode_many = lambda *a: calls.append(1) or many(*a)
    try:
        yield
    finally:
        native.encode, native.encode_many = one, many
    if calls:
        raise AssertionError(f"(x) {what}: the native encoder was called")


FAULT_TIMEOUT = 900  # seconds for phase (x)'s child process
FAULT_WORKER = """
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke
chip_smoke.fault_worker()
"""


def fault_worker(device: str = "cuda", seeds: int = FAULT_SEEDS) -> None:
    """Phase (x)'s work on `device`, in a process of its own: see
    `phase_faults` (`seeds` mutated inputs a codec). Prints its report
    as JSON, last."""
    import torch
    from density_tpu_torch import api, container, native
    from density_tpu_torch.errors import DecodeError
    from density_tpu_torch.parallel import sharding
    dev = torch.device(device)
    t = time.time()
    reset_counts()
    codecs = {"chameleon": 0, "cheetah": 1, "lion": 2}
    # the zero-stream headers: DecodeError on the card, b"" at length 0
    for codec, cid in codecs.items():
        bad, empty = (b for _, b in zero_stream_headers(cid, 5000,
                                                         FAULT_STREAM))
        for fn in (container.decompress, sharding.decode_prep):
            try:
                fn(bad, device=dev)
            except DecodeError as e:
                if "decoded 0 bytes, expected 5000" not in str(e):
                    raise
            else:
                raise AssertionError(f"(x) {codec}: {fn.__name__} of a "
                                     "zero-stream header did not raise")
        if container.decompress(empty, device=dev) != b"":
            raise AssertionError(f"(x) {codec}: empty header")
    # the seeded mutations, on the card against the CPU path
    n_mut = n_equal = 0
    kinds: dict = {}
    for codec in codecs:
        for seed in range(seeds):
            data = fault_input(seed)
            blob = compress_on_device(dev, data, codec, FAULT_STREAM)[0]
            chunks = stream_chunks(data, FAULT_STREAM)
            if payloads(blob) != native.encode_many(codec, chunks):
                raise AssertionError(f"(x) {codec} seed {seed}: container "
                                     "differs from native.encode")
            routes = [contextlib.nullcontext]
            if codec != "chameleon":
                routes.append(device_route)
            for name, bad in mutations(blob, seed):
                for route in routes:
                    with route():
                        card = outcome(container.decompress, bad, device=dev)
                        cpu = outcome(container.decompress, bad,
                                      device="cpu")
                    n_mut += 1
                    if card != cpu:
                        raise AssertionError(
                            f"(x) {codec} seed {seed} {name!r} "
                            f"({route.__name__}): card {card[0]}, CPU "
                            f"{cpu[0]}")
                    n_equal += 1
                    kinds[card[0]] = kinds.get(card[0], 0) + 1
    # the adversarial FSM inputs under both sort options, and the golden
    # vectors, encoded on the card
    n_fsm = 0
    for option in ("default", "bitonic"):
        if option == "bitonic":
            os.environ["DENSITY_TPU_SORT"] = "bitonic"
        try:
            for codec in codecs:
                for case, d in adversarial_inputs().items():
                    with device_encodes_only(f"{codec} {case} ({option})"):
                        enc = api.encode_raw(d, codec, device=dev)
                    if enc != native.encode(codec, d):
                        raise AssertionError(f"(x) {codec} {case} "
                                             f"({option}) differs from "
                                             "native.encode")
                    n_fsm += 1
        finally:
            os.environ.pop("DENSITY_TPU_SORT", None)
    for codec, want in GOLDEN.items():
        with device_encodes_only(f"{codec} golden vector"):
            enc = api.encode_raw(TEST_DATA, codec, device=dev)
        if enc != want or api.decode_raw(want, codec,
                                         device=dev) != TEST_DATA:
            raise AssertionError(f"(x) {codec} golden vector")
    print(json.dumps({"mutations": n_mut, "equal": n_equal,
                      "outcomes": kinds, "fsm_encodes": n_fsm,
                      "launches": read_counts(),
                      "seconds": round(time.time() - t, 3)}), flush=True)


def phase_faults() -> None:
    """(x) The fault surface on the card, in a child process killed at
    FAULT_TIMEOUT, so that a kernel that hangs fails the phase: headers of
    no streams raise DecodeError (decompress and decode_prep) for the
    three codecs; every seeded mutation of `mutations` of each codec's
    `fault_input` containers (compressed on the card, equal to
    `native.encode`) gives the CPU path's outcome and bytes on the card,
    cheetah's and lion's also on the device route; the seven adversarial
    FSM inputs encode to `native.encode`'s bytes with each codec under
    both sort options, and the golden vectors both ways. Every one of
    the seven kernels must launch in it."""
    here = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.Popen([sys.executable, "-c", FAULT_WORKER], cwd=here,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        out, err = p.communicate(timeout=FAULT_TIMEOUT)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    if p.returncode != 0:
        raise AssertionError(f"(x) failed ({p.returncode}): {err[-3000:]}")
    r = json.loads(out.strip().splitlines()[-1])
    low = [k for k, n in r["launches"].items() if n < 1]
    if low or r["equal"] != r["mutations"]:
        raise AssertionError(f"(x) kernels not launched {low}, or outcomes "
                             f"differ: {r}")
    log(f"(x) fault surface: zero-stream headers raise DecodeError on the "
        f"card for 3 codecs; {r['mutations']} mutated containers, "
        f"{r['equal']} outcomes equal to the CPU path's "
        f"{r['outcomes']}; {r['fsm_encodes']} adversarial FSM encodes and "
        f"3 golden vectors equal to native.encode; launches "
        f"{r['launches']}; {r['seconds']:.1f} s")


def main() -> int:
    global OUT_DIR
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory for the compiler and profiler reports")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the input of phases (l) and (q)")
    ap.add_argument("--parent", default=None,
                    help="a tree whose one-device host syncs and launches "
                         "phase (t) must equal (as `one_device_counts` "
                         "counts them there)")
    args = ap.parse_args()
    OUT_DIR = args.out
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import density_tpu_torch  # noqa: F401  (fails outside the repo)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    data = corpus_bytes()
    if len(data) != CORPUS_SIZE:
        raise AssertionError("corpus size")
    rnd = np.random.default_rng(1).integers(0, 256, 1 << 20,
                                            dtype=np.uint8).tobytes()
    errs, inputs, small = phase_parity(dev, data, rnd)
    from density_tpu_torch.engine import layout
    from density_tpu_torch.parallel import sharding
    paths = {codec: (codec_inputs(dev, data, codec),
                     codec_inputs(dev, data, codec, SMALL_STREAMS[1]))
             for codec in ("cheetah", "lion")}
    # the corpus as one stream of the default 32 MiB: 2^22 quads
    large_quads, _ = sharding.stage_encode(
        np.frombuffer(data, np.uint8), len(data), 1,
        layout.bucket_bytes(len(data), 128), len(data), dev)
    for codec, (big_in, small_in) in paths.items():
        for k, e in parity_codec(dev, codec, big_in, small_in,
                                 large_quads).items():
            errs[k] = max(errs[k], e)
    mtf_ops = {K: mtf_shapes(dev, data, K, paths[MTF_SCANS[K][0]][0],
                             large_quads) for K in MTF_SCANS}
    errs["mtf"] = parity_mtf(mtf_ops[5], 5)
    errs["mtf2"] = parity_mtf(mtf_ops[2], 2)
    fsm_ops = fsm_shapes(dev, data, paths)
    errs["fsm"] = parity_fsm(fsm_ops)
    main_counts, main_blob = phase_main_path(dev, data)
    phase_incompressible(dev, rnd)
    small_counts, small_blobs = phase_small_streams(dev, data)
    opt_counts = phase_options(dev, data, main_blob,
                               small_blobs[SMALL_STREAMS[0]])
    phase_api(dev, data)
    large_blobs = phase_large_streams(dev, data)[1]
    big = {"chameleon": large_blobs[LARGE_STREAMS[1]]}
    cheetah_counts, cheetah_blob = phase_codec_main(dev, data, "cheetah")
    conv = {"cheetah": phase_codec_converging(dev, args.seed, "cheetah")}
    phase_cheetah_corpus_decode(dev, data, cheetah_blob)
    big["cheetah"] = phase_codec_sizes(dev, data, "cheetah",
                                       onehot=False)[2][LARGE_STREAMS[1]]
    phase_codec_edges(dev, rnd, "cheetah")
    lion_counts, lion_blob = phase_codec_main(dev, data, "lion")
    conv["lion"] = phase_codec_converging(dev, args.seed, "lion")
    done, n, rounds, dt = corpus_converged(dev, lion_blob, "lion")
    log(f"(q) lion corpus, {n} streams of 256 KiB, device decode at 12 "
        f"rounds: {done} of {n} converged ({rounds} rounds, {dt:.3f} s)")
    _, lion_small_counts, lion_sizes = phase_codec_sizes(dev, data, "lion",
                                                         onehot=True)
    big["lion"] = lion_sizes[LARGE_STREAMS[1]]
    phase_codec_edges(dev, rnd, "lion")
    one = {"chameleon": main_blob, "cheetah": cheetah_blob, "lion": lion_blob}
    from density_tpu_torch import container
    rank_blobs = {}
    for name, (d, stream) in rank_inputs(args.seed).items():
        for codec in one:
            if name == "corpus":
                rank_blobs[name, codec] = one[codec]
            elif name == "alphabet" and codec in conv:
                rank_blobs[name, codec] = conv[codec][1]
            else:
                rank_blobs[name, codec] = container.compress(
                    d, codec, stream, device=dev)
    phase_processes(dev, args.seed, rank_blobs)
    phase_stats(dev, data, one, big)
    phase_sessions(data)
    phase_faults()
    # each kernel's count from its own path's counted run
    counts = {k: main_counts[k] for k in ("bigsort", "packroute", "unpack")}
    counts["pack"] = small_counts["pack"]
    counts["bitonic"] = opt_counts["bitonic"]
    counts["mtf"] = lion_counts["mtf5"]
    counts["mtf2"] = cheetah_counts["mtf2"]
    counts["fsm"] = lion_counts["fsm"]
    log(f"(e) launches: bigsort/packroute/unpack on the main path (c), "
        f"pack on the small-stream paths (g), bitonic under "
        f"DENSITY_TPU_SORT=bitonic (h), mtf at K=5 on lion's main path "
        f"(p), one a plan, at K=2 (mtf2) on cheetah's (k), one a copy-free "
        f"plan, fsm on lion's main path (p), one a pass of the fixed "
        f"point: {counts}; on cheetah's main path "
        f"(k): {cheetah_counts}; on lion's main path (p): {lion_counts}, "
        f"its 16 KiB path (r): {lion_small_counts}")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {counts}")
    rows = phase_timing(dev, inputs, small)
    rows.update(phase_small_timing(dev, inputs, small))
    time_sort_3(dev, paths["cheetah"][0], large_quads)
    time_lion_packs(*paths["lion"])
    rows["mtf"] = time_mtf(mtf_ops[5], 5)
    rows["mtf2"] = time_mtf(mtf_ops[2], 2)
    rows["fsm"] = time_fsm(fsm_ops)
    for codec, blob in (("cheetah", cheetah_blob), ("lion", lion_blob)):
        conv_data, _, conv_dargs = conv[codec]
        time_codec(dev, codec, paths[codec][0], conv_dargs, conv_data, data,
                   blob)
    # (t) after (f): with (t) before it in one process, (f)'s profiler
    # sessions came back with no device event in most runs (PERF.md)
    phase_shares(dev, data, one, conv, small_blobs[SMALL_STREAMS[1]],
                 large_blobs[LARGE_STREAMS[0]], args.parent, args.seed)
    kernels = [dict(name=name, route="cuda", source="density_tpu_torch/csrc/"
                    f"{SOURCE.get(name, name)}.cu",
                    replaces=REPLACES[name], launches=counts[name],
                    max_abs_err=errs[name], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                    bound_by=r["bound"][1], library_ms=r["library_ms"])
               for name, r in rows.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
