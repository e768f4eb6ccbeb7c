"""Encode assembly in 4096-quad tiles: the port of the TPU one-hot pack
kernel.

Counterpart of `density_tpu/kernels/pack.py::pack`, which the JAX
package takes where a stream's quad count is a multiple of 4096 but not
of 16384 (4096- and 8192-quad streams) and, under
`DENSITY_TPU_PACK=onehot`, at every size. Its contract is
`packroute.pack`'s, for N a multiple of 4096 (`GQ_MIN`): per-quad tokens
(flags, pw, w0, w1) and per-stream byte counts become block streams

    [signature words][w0 (w1) for each token] per real block,

padding blocks adding nothing and the ragged tail after the last real
block's payload. The signature is packed per bit, so 3-bit flags may
cross u16 words.

On a CUDA tensor `pack` launches `csrc/pack.cu` (one CTA per stream,
4096-quad tiles assembled in shared memory); on a CPU tensor it runs
`pack_plain`. Output: (S, packroute.out_width) int32 holding u16 values,
zero past each stream's end.
"""

from __future__ import annotations

import torch

from density_tpu_torch.kernels import _build, packroute

GQ_MIN = 4096  # quads per tile (the TPU kernel's group quantum)
launches = 0  # kernel launches through `pack` (see chip_smoke.py)


def _check_args(flags, pw, w0, w1, nbytes, q, flag_bits):
    packroute.check_args(flags, pw, w0, w1, nbytes, q)
    N = flags.shape[1]
    if N % GQ_MIN:
        raise ValueError(f"N={N} is not a multiple of {GQ_MIN}")
    if flag_bits not in (1, 2, 3):
        raise ValueError(f"flag_bits={flag_bits}")


def pack(flags, pw, w0, w1, nbytes, *, q, sig_words, block, flag_bits):
    """Assemble S block streams; see the module docstring."""
    _check_args(flags, pw, w0, w1, nbytes, q, flag_bits)
    if flags.device.type != "cuda":
        return pack_plain(flags, pw, w0, w1, nbytes, q=q,
                          sig_words=sig_words, block=block,
                          flag_bits=flag_bits)
    S, N = flags.shape
    ow = packroute.out_width(N, q, sig_words)
    args = [a.to(torch.int32).contiguous()
            for a in (flags, pw, w0, w1, nbytes)]
    out = torch.empty((S, ow), dtype=torch.int32, device=flags.device)
    fn = _build.function("pack", "pack", 14, tuple(range(6, 13)))
    _build.launch(fn, "pack", flags.device, *[_build.ptr(a) for a in args],
                  _build.ptr(out), S, N, q, sig_words, flag_bits, block, ow)
    _build.count_launch(globals())
    return out


def pack_plain(flags, pw, w0, w1, nbytes, *, q, sig_words, block,
               flag_bits):
    """The kernel's arithmetic in plain PyTorch: `packroute.pack_plain`,
    which has the same contract."""
    _check_args(flags, pw, w0, w1, nbytes, q, flag_bits)
    return packroute.pack_plain(flags, pw, w0, w1, nbytes, q=q,
                                sig_words=sig_words, block=block,
                                flag_bits=flag_bits)
