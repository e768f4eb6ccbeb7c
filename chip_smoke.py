#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`density_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--out DIR]

Needs one CUDA card and `nvcc`; imports no JAX. Phases:
  (a) build the three CUDA kernels from `density_tpu_torch/csrc/`;
  (b) hold each kernel against its plain PyTorch version on the card,
      bit for bit, at the main path's shapes (and a malformed-offset
      case that must raise DecodeError);
  (c) the main path: chameleon compress and decompress on the card of a
      10,192,446-byte text corpus in 256 KiB streams, with every
      kernel's launch count read around it; stream bytes held against
      the port's CPU path and its scalar encoder, and the golden vector;
  (d) incompressible and mixed inputs (fixed point, copy blocks, ragged
      lengths);
  (e) the launch counts of (c);
  (f) timings: device-resident encode and decode with CUDA events; the
      device time of each kernel, its plain version and the library call
      beside it, from torch.profiler; then one profiler trace each of
      encode and decode (device busy share, the kernels that take it).
Prints the card's name and power limit, a `kernels` JSON line and, last,
the device JSON line. Any failure exits non-zero. Writes the compiler's
register report to `DIR/ptxas.txt` and the profiles to
`DIR/profile_{encode,decode}.txt` (DIR: `--out`, by default `smoke_out`).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

STREAM = 256 << 10  # bytes per stream of the device grain
CORPUS_SIZE = 10_192_446
REPEATS = 5  # timing windows of the device-resident encode and decode
OUT_DIR = "smoke_out"  # reports too long for the standard output
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
ALU_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit rate (data sheet)
TEST_DATA = b"test" * 31 + b"t"
GOLDEN_CHAMELEON = bytes([0xfe, 0xff, 0xff, 0x7f, 0, 0, 0, 0,
                          116, 101, 115, 116] + [112, 251] * 30 + [116])
REPLACES = {
    "bigsort": "density_tpu/kernels/bigsort.py:166",
    "packroute": "density_tpu/kernels/packroute.py:161",
    "unpack": "density_tpu/kernels/unpack.py:379",
}


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


def device_ms(fn, iters: int = 10) -> float:
    """Mean device time per call: the card's own events (kernels, copies,
    memsets) under torch.profiler, summed, so that the host's launch
    gaps, which vary from machine to machine, are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type != DeviceType.CPU)
    if us <= 0:
        raise AssertionError("the profiler saw no device time")
    return us / 1e3 / iters


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phases

def phase_build() -> None:
    from density_tpu_torch.kernels import _build
    t = time.time()
    logs = _build.build()
    log(f"(a) built {sorted(logs) or 'nothing (cached)'} "
        f"in {time.time() - t:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in logs.items():
            f.write(f"== {name}\n{text}\n")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line:
                log(f"    {name}: {line.strip()}")


def main_path_inputs(dev, data: bytes):
    """Staged encode inputs of the 38 full streams, the plan the main
    path hands the pack kernel, and the staged decode inputs."""
    import torch
    from density_tpu_torch import container
    from density_tpu_torch.codecs import chameleon
    from density_tpu_torch.engine import layout
    from density_tpu_torch.parallel import sharding
    s_full = len(data) // STREAM
    buf = np.frombuffer(data, np.uint8)
    quads, nbytes = sharding.stage_encode(
        buf[:s_full * STREAM], s_full * STREAM, s_full,
        layout.bucket_bytes(STREAM, 256), STREAM, dev)
    # three streams end ragged (tails 1, 3 and 555 bytes)
    nb_rag = nbytes.clone()
    nb_rag[1:4] -= torch.tensor([1, 3, 555], dtype=torch.int32, device=dev)
    flags, pw, w0, w1, _, _ = chameleon.plan_fast(quads, nb_rag)
    w0, w1 = layout.stamp_ragged(quads, nb_rag, w0, w1)
    blob = container.compress(data[:s_full * STREAM], "chameleon", STREAM,
                              device=dev)
    dargs, streams, _ = sharding.decode_prep(blob, dev)
    live_bytes = sum(len(s) for s in streams)  # compressed payload
    return quads, nbytes, (flags, pw, w0, w1, nb_rag), dargs, live_bytes


def phase_parity(dev, data: bytes, rnd: bytes):
    """Each kernel against its plain version, on the card, bit-exact."""
    import torch
    from density_tpu_torch.engine import grouping
    from density_tpu_torch.errors import DecodeError
    from density_tpu_torch.kernels import bigsort, packroute, unpack
    from density_tpu_torch.parallel import sharding
    errs = {}
    rng = np.random.default_rng(0)
    inputs = main_path_inputs(dev, data)
    quads, nbytes, pack_in, dargs, _ = inputs
    S, N = quads.shape
    # sort: the encode's forward sort (biased hash|index key + quad), a
    # 2-key 2^17 sort, a 3-array sort and a small 1-array sort
    key = ((grouping.hash_quads(quads) << 16)
           | torch.arange(N, dtype=torch.int32, device=dev)) ^ (-2**31)
    cases = [((key, quads), 1)]
    for shape, na, nk in [((2, 1 << 17), 2, 2), ((4, 16384), 3, 2),
                          ((3, 256), 1, 1)]:
        arrs = tuple(torch.from_numpy(rng.integers(
            -2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).to(dev)
            for _ in range(na))
        cases.append((arrs, nk))
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
    log(f"(b) bigsort: {len(cases)} cases, max_abs_err {err}")

    kw = dict(q=64, sig_words=4, block=256, flag_bits=1)
    got = packroute.pack(*pack_in, **kw)
    torch.cuda.synchronize()
    errs["packroute"] = max_abs_err(got, packroute.pack_plain(*pack_in, **kw))
    log(f"(b) packroute: S={S} N={N} with tails 1/3/555, "
        f"max_abs_err {errs['packroute']}")

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
    errs["unpack"] = err
    bad = woff_k.clone()
    bad[0, 5] = words.shape[1] + 7
    try:
        unpack.unpack(words, bad, is_copy, **ukw)
    except DecodeError:
        pass
    else:
        raise AssertionError("malformed offset did not raise DecodeError")
    torch.cuda.synchronize()
    log(f"(b) unpack: main path + copy blocks, max_abs_err {err}; "
        "malformed offset raised DecodeError")
    return errs, inputs


def phase_main_path(dev, data: bytes):
    """Chameleon compress + decompress on the card, counted."""
    from density_tpu_torch import container, host_scan
    from density_tpu_torch.codecs import chameleon
    from density_tpu_torch.kernels import bigsort, packroute, unpack
    mods = {"bigsort": bigsort, "packroute": packroute, "unpack": unpack}
    for m in mods.values():
        m.launches = 0
    t = time.time()
    blob = container.compress(data, "chameleon", STREAM, device=dev)
    back = container.decompress(blob, device=dev)
    dt = time.time() - t
    counts = {k: m.launches for k, m in mods.items()}
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
    if chameleon.encode(TEST_DATA, device=dev) != GOLDEN_CHAMELEON:
        raise AssertionError("golden vector mismatch")
    if chameleon.decode(GOLDEN_CHAMELEON, device=dev) != TEST_DATA:
        raise AssertionError("golden vector decode mismatch")
    log(f"(c) main path: {len(data)} bytes in {len(parts)} streams -> "
        f"{len(blob)} bytes (ratio {len(data) / len(blob):.4f}), round trip "
        f"exact in {dt:.2f} s host wall; streams 0/{len(parts) - 1} equal "
        "the CPU path, stream 1 the scalar encoder; golden vector exact")
    return counts


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


def phase_timing(dev, inputs, data: bytes):
    import torch
    from density_tpu_torch.codecs import chameleon
    from density_tpu_torch.engine import grouping, layout
    from density_tpu_torch.kernels import bigsort, packroute, unpack
    from density_tpu_torch.parallel import sharding
    quads, nbytes, pack_in, dargs, live_bytes = inputs
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
    for name, fn in (("encode", enc),
                     ("decode", lambda: sharding.decode_batch(*dargs))):
        runs = sorted(timed_ms(fn) for _ in range(REPEATS))
        times[name] = statistics.median(runs)
        log(f"(f) device-resident {name} S={S} N={N}: median "
            f"{times[name]:.3f} ms = {enc_bytes / times[name] / 1e6:.3f} "
            f"GB/s of input (range {runs[0]:.3f}-{runs[-1]:.3f} ms, "
            f"{REPEATS} windows of 10 calls)")
    enc_ms, dec_ms = times["encode"], times["decode"]

    rows = {}
    key = ((grouping.hash_quads(quads) << 16)
           | torch.arange(N, dtype=torch.int32, device=dev)) ^ (-2**31)
    sort_bytes = 2 * 2 * S * N * 4
    rows["bigsort"] = dict(
        ms=device_ms(lambda: bigsort.sort(key, quads, n_keys=1)),
        plain_ms=device_ms(
            lambda: bigsort.sort_plain(key, quads, n_keys=1), iters=2),
        library_ms=device_ms(lambda: torch.sort(key, dim=1)),
        bound=bound_ms(sort_bytes, S * N * np.log2(N)),
        shape=f"S={S} N={N} 1 key 2 arrays")
    kw = dict(q=64, sig_words=4, block=256, flag_bits=1)
    out_w = packroute.out_width(N, 64, 4)
    rows["packroute"] = dict(
        ms=device_ms(lambda: packroute.pack(*pack_in, **kw)),
        plain_ms=device_ms(
            lambda: packroute.pack_plain(*pack_in, **kw), iters=3),
        library_ms=None,
        bound=bound_ms(4 * S * N * 4 + S * 4 + S * out_w * 4, 0),
        shape=f"S={S} N={N}")
    words, woff, is_copy, nb_real, _ = dargs
    live = torch.arange(woff.shape[1], device=dev)[None, :] < nb_real[:, None]
    woff_k = torch.where(live, woff, -1)
    ukw = dict(q=64, sig_words=4, flag_bits=1)
    W, NB = words.shape[1], woff.shape[1]
    rows["unpack"] = dict(
        ms=device_ms(lambda: unpack.unpack(words, woff_k, is_copy, **ukw)),
        plain_ms=device_ms(
            lambda: unpack.unpack_plain(words, woff_k, is_copy, **ukw),
            iters=3),
        library_ms=None,
        # the words it needs are the compressed payload's, 4 bytes each
        bound=bound_ms(2 * live_bytes + S * NB * 5 + 3 * S * NB * 64 * 4,
                       0),
        shape=f"S={S} W={W} NB={NB}")
    for name, r in rows.items():
        lib = (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
               else "n/a")
        log(f"(f) {name} [{r['shape']}]: device {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    phase_profile({"encode": enc,
                   "decode": lambda: sharding.decode_batch(*dargs)})
    return rows, enc_ms, dec_ms


def phase_profile(fns) -> None:
    """One traced call of each device-resident function: wall time, the
    device's busy time (the sum of its kernels' self times) and the
    kernels that take it. Full tables go to OUT_DIR."""
    import torch
    from torch.autograd import DeviceType
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
                       for e in ka if e.device_type != DeviceType.CPU
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


def main() -> int:
    global OUT_DIR
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory for the compiler and profiler reports")
    OUT_DIR = ap.parse_args().out
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
    errs, inputs = phase_parity(dev, data, rnd)
    counts = phase_main_path(dev, data)
    phase_incompressible(dev, rnd)
    log(f"(e) launches on the main path: {counts}")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {counts}")
    rows, _, _ = phase_timing(dev, inputs, data)
    kernels = [dict(name=name, route="cuda",
                    source=f"density_tpu_torch/csrc/{name}.cu",
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
