"""unpack's share of its roofline on this cell's compressed streams: the
first object's full streams compressed by the program on the first card,
staged for the decode (`sharding.decode_prep`). The probe runs 20 token
extractions, warm, in the traced run's profiler session after the
window; their time is their device events' in that trace
(`probes.probe_ms`); the bound counts the payload's bytes, the block
offsets and copy flags read and the three token lattices written, each
once (`peaks.unpack_bound`). Nothing for a codec that decodes without
unpack (cheetah and lion gather their tokens)."""

from portbench import peaks, probes
from portbench.reference.density import GEOMETRY

NAME = "unpack_roofline"
ITERS = 20


def probe(ctx, tracer):
    if not ctx.cards or ctx.system.codec != "chameleon":
        return
    import torch
    from density_tpu_torch.kernels import unpack
    from density_tpu_torch.parallel import sharding
    size = ctx.system.stream_size
    data = ctx.objects[ctx.order[0]]
    S = len(data) // size
    if S == 0:
        return
    dev = torch.device("cuda", ctx.cards[0])
    blob = ctx.system.compress(data[:S * size])
    dargs, streams, _ = sharding.decode_prep(blob, dev)
    words, woff, is_copy, nb_real, _ = dargs
    NB = woff.shape[1]
    live = torch.arange(NB, device=dev)[None, :] < nb_real[:, None]
    woff_k = torch.where(live, woff, -1)
    bits, sig_bytes, block = GEOMETRY[ctx.system.codec]
    kw = dict(q=block // 4, sig_words=sig_bytes // 2, flag_bits=bits)
    counted = probes.run_probe(
        tracer, NAME,
        lambda: unpack.unpack_flagged(words, woff_k, is_copy, **kw),
        lambda: unpack.launches, ITERS)
    ctx.probed[NAME] = (counted, S, NB, block // 4,
                        sum(len(s) for s in streams), words.shape[1])


def read(ctx):
    if NAME not in ctx.probed or ctx.trace is None:
        return None
    counted, S, NB, q, payload, W = ctx.probed[NAME]
    ms = probes.probe_ms(ctx.trace, NAME, ("unpack_kernel",), ITERS, counted)
    if ms is None:
        return None
    bound, by = peaks.unpack_bound(S, NB, q, payload)
    ctx.log(f"{NAME}: S={S} W={W} NB={NB}, {ms:.4f} ms a call on the "
            f"device, bound {bound:.4f} ms ({by}); {ctx.card_line}")
    return 100.0 * bound / ms
