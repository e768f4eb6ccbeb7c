"""bigsort's share of its roofline at the shape the encode's forward sort
gives it in this cell: the first object's full streams on the first
card, S rows of the stream's quads (padded to a power of two), one key
(hash << 16 | index, biased) and the quads carried, 2 arrays. The probe
runs 20 sorts, warm, in the traced run's profiler session after the
window; their time is their device events' in that trace
(`probes.probe_ms`); the bound counts each array read and written once
(`peaks.sort_bound`)."""

import numpy as np

from portbench import peaks, probes

NAME = "bigsort_roofline"
HASH_MULTIPLIER_I32 = 0x9D6EF916 - (1 << 32)
KERNEL_NAMES = ("tile_kernel", "global_kernel")
ITERS = 20


def probe(ctx, tracer):
    if not ctx.cards:
        return
    import torch
    from density_tpu_torch.kernels import bigsort
    size = ctx.system.stream_size
    data = ctx.objects[ctx.order[0]]
    S, n_q = len(data) // size, size // 4
    if S == 0:
        return
    N = 1 << max(0, n_q - 1).bit_length()
    quads = np.zeros((S, N), np.int32)
    quads[:, :n_q] = np.frombuffer(data, "<i4", S * n_q).reshape(S, n_q)
    dev = torch.device("cuda", ctx.cards[0])
    q = torch.from_numpy(quads).to(dev)
    h = ((q * HASH_MULTIPLIER_I32) >> 16) & 0xFFFF
    key = ((h << 16) | torch.arange(N, dtype=torch.int32, device=dev)) ^ (
        -2**31)
    counted = probes.run_probe(tracer, NAME,
                               lambda: bigsort.sort(key, q, n_keys=1),
                               lambda: bigsort.launches, ITERS)
    ctx.probed[NAME] = (counted, S, N)


def read(ctx):
    if NAME not in ctx.probed or ctx.trace is None:
        return None
    counted, S, N = ctx.probed[NAME]
    ms = probes.probe_ms(ctx.trace, NAME, KERNEL_NAMES, ITERS, counted)
    if ms is None:
        return None
    bound, by = peaks.sort_bound(S, N, 2)
    ctx.log(f"{NAME}: S={S} N={N} 1 key 2 arrays, {ms:.4f} ms a sort on "
            f"the device, bound {bound:.4f} ms ({by}); {ctx.card_line}")
    return 100.0 * bound / ms
