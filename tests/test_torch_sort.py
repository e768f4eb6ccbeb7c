"""The port's sort kernel module (density_tpu_torch.kernels.bigsort)
against the JAX package's Pallas sort kernel, run in interpret mode on
the CPU.

Here the wrapper takes its plain PyTorch version (the tensors lie on the
CPU); the CUDA kernel is held against that same plain version on the
card by `chip_smoke.py` and the `gpu`-marked tests. Both packages get
the same numpy inputs, made from a seed; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from density_tpu.kernels import bigsort as jbigsort
from density_tpu_torch.kernels import bigsort

# The test workers share the machine's cores with each other and with
# XLA; torch's own thread pool on top of them only oversubscribes it.
torch.set_num_threads(1)


def _i32(rng, shape, lo, hi):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


# ---------------------------------------------------------------- sort

# Each case is one XLA compile of the interpreted Pallas kernel (about
# 4 s at N=256, 12 s at N=16384), so the cases cover 1 and 2 keys and
# 1-3 arrays between them; the 1-key sorts at N=16384 are also held to
# the Pallas kernel inside plan_fast_pallas and resolve_chameleon
# (tests/test_torch_modules.py).
@pytest.mark.parametrize("N,n_keys,n_arr,ties", [
    (256, 1, 1, False), (256, 2, 3, False), (16384, 2, 2, True)])
def test_bigsort_matches_pallas(N, n_keys, n_arr, ties):
    """Signed (biased, negative) keys; with many ties the carried arrays
    show that both run the same compare-exchange network."""
    rng = np.random.default_rng(N + 10 * n_keys + n_arr)
    hi = 40 if ties else 2**31
    arrs = [_i32(rng, (2, N), -hi, hi) for _ in range(n_arr)]
    want = jbigsort.sort(*map(jnp.asarray, arrs), n_keys=n_keys,
                         interpret=True)
    got = bigsort.sort(*map(torch.from_numpy, arrs), n_keys=n_keys)
    assert len(got) == n_arr
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bigsort.launches == 0  # the CPU never launches the kernel


def test_bigsort_multisegment_2p17(monkeypatch):
    """N = 2^17 through the TPU kernel's multi-segment schedule (segment
    shrunk so interpret mode stays fast), 2 keys, as the planners sort
    above 2^16 quads."""
    monkeypatch.setattr(jbigsort, "SEG", 512)
    rng = np.random.default_rng(17)
    N = 1 << 17
    k1 = _i32(rng, (1, N), 0, 50)
    k2 = _i32(rng, (1, N), -2**31, 2**31)
    want = jbigsort.sort(jnp.asarray(k1), jnp.asarray(k2), n_keys=2,
                         interpret=True)
    got = bigsort.sort(torch.from_numpy(k1), torch.from_numpy(k2), n_keys=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
