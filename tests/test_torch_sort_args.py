"""Arguments the port's sort wrapper (density_tpu_torch.kernels.bigsort)
refuses before it reaches a kernel or the plain network, on any device.
The kernel itself is held to the plain network on the card
(`tests/test_torch_gpu.py`)."""

import numpy as np
import pytest
import torch

from density_tpu_torch.kernels import bigsort


def _arrays(S, N, n):
    rng = np.random.default_rng(S + N + n)
    return [torch.from_numpy(rng.integers(-50, 50, (S, N)).astype(np.int32))
            for _ in range(n)]


@pytest.mark.parametrize("arrays,n_keys", [
    (_arrays(2, 64, 4), 1),   # more than 3 arrays
    (_arrays(2, 64, 3), 3),   # more than 2 keys
    (_arrays(2, 64, 1), 2),   # more keys than arrays
    (_arrays(2, 64, 2), 0),   # no key
    (_arrays(2, 96, 2), 1),   # N not a power of two
    (_arrays(2, 1, 1), 1),    # N below 2
    (_arrays(2, 64, 1) + _arrays(3, 64, 1), 1),  # shapes differ
])
def test_bad_args_raise(arrays, n_keys):
    with pytest.raises(ValueError):
        bigsort.sort(*arrays, n_keys=n_keys)
    with pytest.raises(ValueError):
        bigsort.sort_plain(*arrays, n_keys=n_keys)
