"""Spans at the port's layer boundaries, on the profiler's clock.

`span(name)` marks a region of the host's work as the profiler range
`density.<name>`, where `<name>` is `<layer>.<what>` and `<layer>` is one
of `container`, `sharding`, `engine`, `native` and `wait`. The switch is
a `torch.profiler` session: while none records on this thread, `span`
returns one shared no-op context after one check and enters nothing.
While one records, the spans are `torch.profiler.record_function`
ranges, kept by that session with its kernel and copy events on one
clock, nested as the calls nest, and exported by whoever opened it
(`export_chrome_trace`, or its events). `traced(name)` makes each call
of a function the span `name`.

A profiler session records on the thread that opened it and on the
threads that inherit its thread-local state, which the shares' workers
do (`parallel.mesh.run_shares`).
"""

import contextlib
import functools

import torch

PREFIX = "density."

# `recording()`: whether a profiler session records on this thread, in
# one C call
recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """The range `density.<name>` of the profiler session recording on
    this thread, or a shared no-op context while none records."""
    if not recording():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def traced(name: str):
    """A decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(PREFIX + name):
                return fn(*args, **kwargs)
        return call
    return wrap

