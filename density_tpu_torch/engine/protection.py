"""Blowup-protection FSM, replayed on the host over a batch of streams.

Bit-exact replay of the reference's adaptive revert-to-copy machine
(reference: src/codec/protection_state.rs:9-47, driven at
codec.rs:35-37,68 and codec.rs:89-98); the counterpart of the JAX
package's `engine/protection.py`. The FSM is part of the wire format:
encoder and decoder replay it in lockstep with no metadata.

  - revert_to_copy() is consulted for EVERY block (ticking the counter,
    and halving copy_penalty_start -- floor 1 -- on every 16th tick);
  - if copy_penalty > 0 the block is a verbatim copy and decay() runs
    (penalty -= 1; on reaching 0, copy_penalty_start += 1);
  - otherwise the block is encoded and update(incompressible) runs:
    two consecutive incompressible blocks arm copy_penalty.

This is the plain version of the FSM step (`kernels/fsm.py::step_plain`,
the CPU path, and the reference the card's kernel `csrc/fsm.cu` is held
to): a scalar loop over each stream's blocks.
"""

from __future__ import annotations

import numpy as np


def _replay_one(bits: list) -> list:
    penalty, start, prev = 0, 1, False
    out = [False] * len(bits)
    for i, bit in enumerate(bits):
        if (i & 15) == 0 and start > 1:
            start >>= 1
        if penalty > 0:  # copy path: decay()
            out[i] = True
            penalty -= 1
            if penalty == 0:
                start += 1
        else:  # encode path: update(bit)
            if bit and prev:
                penalty = start
            prev = bool(bit)
    return out


def replay_fsm(incompressible_bits) -> np.ndarray:
    """Per-block copy decisions for (S, nb) (or (nb,)) hypothetical
    incompressible bits, as if each block were encoded. The bit of a
    block the FSM decides to copy is ignored (update() is skipped on
    the copy path)."""
    bits = np.asarray(incompressible_bits, dtype=bool)
    rows = np.atleast_2d(bits).tolist()
    out = np.array([_replay_one(r) for r in rows], dtype=bool)
    return out.reshape(bits.shape)
