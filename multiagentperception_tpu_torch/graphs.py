"""CUDA graphs of the eval and train steps: the port's counterpart of one
jitted dispatch per step (JAX trainer.py:366-395, :457-544).

A step of the flagship launches hundreds of kernels, each with tens of
microseconds of host work; at batch 2 the host, not the card, sets the
pace. A captured step replays all of them in one launch.

- ``capture(key, body, inputs, pool, stream)`` runs ``body(inputs)`` under
  ``torch.cuda.graph`` on a side stream, in ``capture_error_mode
  "thread_local"`` (the train loop's prefetch thread copies on its own
  stream meanwhile) and with PyTorch's sync debug mode at ``"error"``: a
  host sync inside the capture raises. Any failure raises ``CaptureError``
  naming the key; nothing falls back to the eager step.
- The kernels' launch counters (``upsample_argmax.launches``, each
  ``route_launches``, ``int8_conv.geometry_launches``, ...; and an
  ``Int8Convs`` swap's ``calls``) are Python numbers that a capture moves
  once. ``capture`` takes back what the capture added and keeps it as the
  graph's ``delta``; every ``Graph.replay`` adds the delta, so the counts
  stay exact per step.
- ``GraphCache`` keeps the eval graphs, keyed by what changes the captured
  work: the first step of a key runs eagerly on the side stream (the
  warm-up: cuDNN and cuBLAS state for that stream, lazily built device
  constants, quantized weights), the second is captured, the rest replay.
  Host inputs are copied from pinned memory into the graph's static
  buffers before each replay; the outputs, which the next replay
  overwrites, are copied out after it.

Whatever a graph reads must stay where it was at capture: parameters are
updated in place, and the constants built at first use
(``ops.resize``'s weights, K1's taps, ``ops.normalize``'s mean, K4's
packed weights and scales) are cached without eviction; a graph also holds
references to what its key names (``keep``).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

_WARM = object()  # a key whose warm-up ran; its next step is captured


class CaptureError(RuntimeError):
    """A CUDA graph capture failed; the message names the graph's key."""


def _sources(extra=()) -> tuple:
    from multiagentperception_tpu_torch.ops.kernels import (
        comm_fusion,
        fused_block,
        int8_conv,
        upsample_argmax,
    )
    return (upsample_argmax.upsample_argmax, comm_fusion.comm_fusion, int8_conv.int8_conv,
            fused_block.fused_basic_block, *extra)


def counts(extra=()) -> dict:
    """Every launch counter (an int attribute ending in ``launches``, each
    entry of such a dict, and ``calls``) of the kernel wrappers and of the
    objects in ``extra``: ``{(owner, attribute, key or None): value}``."""
    out = {}
    for owner in _sources(extra):
        for attr, value in vars(owner).items():
            if not (attr == "calls" or attr.endswith("launches")):
                continue
            if isinstance(value, dict):
                out.update({(owner, attr, k): v for k, v in value.items()})
            elif isinstance(value, int):
                out[(owner, attr, None)] = value
    return out


def add_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign * delta`` to the counters ``delta`` names."""
    for (owner, attr, key), d in delta.items():
        if key is None:
            setattr(owner, attr, getattr(owner, attr) + sign * d)
        else:
            getattr(owner, attr)[key] += sign * d


class Graph:
    """A captured step: ``replay()`` launches it on the current stream and
    adds the launches it holds to the counters. ``inputs`` are its static
    input buffers (fill them before a replay), ``outputs`` what the
    capture's body returned (overwritten by each replay); ``keep`` holds
    references to what the graph reads beyond them."""

    def __init__(self, key, graph, inputs: dict, outputs, delta: dict, keep=()):
        self.key, self.graph, self.inputs, self.outputs, self.delta, self.keep = (
            key, graph, inputs, outputs, delta, keep)

    def replay(self) -> None:
        self.graph.replay()
        add_counts(self.delta)


@contextlib.contextmanager
def _sync_errors():
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def capture(key, body: Callable, inputs: dict, pool, stream: torch.cuda.Stream,
            extra_counters=(), keep=()) -> Graph:
    """Capture ``body(inputs)`` into a CUDA graph (module docstring). Its
    launch counts are taken back from the counters into the graph's delta."""
    before = counts(extra_counters)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            with _sync_errors():
                outputs = body(inputs)
    except Exception as err:
        add_counts({k: v - before[k] for k, v in counts(extra_counters).items()}, -1)
        raise CaptureError(f"CUDA graph capture of {key!r} failed: {err}") from err
    delta = {k: v - before[k] for k, v in counts(extra_counters).items() if v != before[k]}
    add_counts(delta, -1)
    return Graph(key, graph, inputs, outputs, delta, keep)


def on_stream(stream: torch.cuda.Stream, fn: Callable):
    """``fn()`` on ``stream``, ordered after the current stream's work and
    before its later work; returned tensors are marked as used by the
    current stream."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    for t in (out.values() if isinstance(out, dict) else ()):
        t.record_stream(current)
    return out


def pinned(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_pinned() else t.pin_memory()


class GraphCache:
    """The eval graphs of one evaluator (module docstring). ``run(key,
    host, body)``: ``host`` maps names to CPU tensors, ``body(inputs)``
    computes a dict of device tensors from the same names on the device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.entries: dict = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

    def _put(self, host: dict) -> dict:
        return {k: pinned(v).to(self.device, non_blocking=True) for k, v in host.items()}

    def run(self, key, host: dict, body: Callable, extra_counters=(), keep=()) -> dict:
        entry = self.entries.get(key)
        if entry is None:  # the warm-up, eager, on the capture stream
            inputs = self._put(host)
            out = on_stream(self.stream, lambda: body(inputs))
            self.entries[key] = _WARM
            return out
        if entry is _WARM:
            static = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                      for k, v in host.items()}
            entry = self.entries[key] = capture(key, body, static, self.pool, self.stream,
                                                extra_counters, keep)
        for name, buf in entry.inputs.items():
            buf.copy_(pinned(host[name]), non_blocking=True)
        entry.replay()
        return {k: v.clone() for k, v in entry.outputs.items()}
