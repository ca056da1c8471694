"""The port's recorder of host spans: which block of the program was running,
on the profiler's clock.

`span(name)` marks a block of code.  `recording()` turns the recorder on for
a `with` block and yields the list its spans go into; it is the only switch.
Off (the default), `span` returns one shared no-op context after a single
read of the module's recorder slot: it allocates nothing, syncs nothing and
adds nothing to autograd's graph.  The spans stay in memory; the caller
reads the list.

A span records its name, start and end (`time.time_ns()`), the index in the
list of the span that was open when it started (None at the top) and the
native id of the thread that opened it.  The open spans form one stack for
every thread: autograd runs the backward pass of CUDA tensors on a thread of
its own while the caller waits inside `.backward()`, so the spans of that
thread nest inside the caller's.  `time.time_ns()` is the Unix clock, the
one torch.profiler (kineto) converts its runtime and device events to, so a
span covers the runtime calls that launched its kernels with no alignment.

`backward_span(name, fn, *inputs, **options)` gives fn's backward pass a
span of its own while recording: an identity autograd marker on fn's
outputs opens it when the gradient reaches them, one on fn's inputs closes
it when the gradient has passed through fn.  Off, it is
`fn(*inputs, **options)`: no marker is inserted.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Iterator, List, Optional, Tuple

import torch


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: Optional[int]           # None while the span is open
    parent: Optional[int]           # index of the enclosing span
    thread: int                     # native id of the thread that opened it


class _Recorder:
    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._open: List[int] = []
        self._lock = threading.Lock()

    def enter(self, name: str) -> int:
        with self._lock:
            i = len(self.spans)
            self.spans.append(Span(name, time.time_ns(), None,
                                   self._open[-1] if self._open else None,
                                   threading.get_native_id()))
            self._open.append(i)
        return i

    def exit(self, i: int) -> None:
        with self._lock:
            self.spans[i].end_ns = time.time_ns()
            if self._open[-1] == i:
                self._open.pop()
            else:                   # another thread's span closed out of turn
                self._open.remove(i)


class _Open:
    """One span of the recorder that was on when the context was made."""
    __slots__ = ("rec", "name", "index")

    def __init__(self, rec: _Recorder, name: str) -> None:
        self.rec, self.name = rec, name

    def __enter__(self) -> "_Open":
        self.index = self.rec.enter(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        self.rec.exit(self.index)
        return False


_NOOP = contextlib.nullcontext()
_recorder: Optional[_Recorder] = None


def span(name: str):
    """A context that records `name` while the recorder is on."""
    rec = _recorder
    if rec is None:
        return _NOOP
    return _Open(rec, name)


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """The recorder on for the block; yields the list of its spans."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("the recorder is already on")
    rec = _recorder = _Recorder()
    try:
        yield rec.spans
    finally:
        _recorder = None


class _Marker(torch.autograd.Function):
    """The identity on its tensors; `hook()` once the backward pass has
    reached all of them."""

    @staticmethod
    def forward(ctx, hook, *xs):
        ctx.hook = hook
        ctx.set_materialize_grads(False)
        out = tuple(x.view_as(x) for x in xs)
        ctx.mark_non_differentiable(*(o for o, need in zip(
            out, ctx.needs_input_grad[1:]) if not need))
        return out

    @staticmethod
    def backward(ctx, *grads):
        ctx.hook()
        return (None, *grads)


def backward_span(name: str, fn: Callable[..., Tuple[torch.Tensor, ...]],
                  *inputs: torch.Tensor, **options
                  ) -> Tuple[torch.Tensor, ...]:
    """fn(*inputs, **options) (a tuple of tensors), its backward pass with
    respect to `inputs` inside the span `name` while the recorder is on and
    autograd records."""
    rec = _recorder
    if rec is None or not torch.is_grad_enabled():
        return fn(*inputs, **options)
    opened: List[_Open] = []

    def open_() -> None:
        opened.append(_Open(rec, name).__enter__())

    def close() -> None:
        if opened:
            opened.pop().__exit__(None, None, None)
    return _Marker.apply(open_, *fn(*_Marker.apply(close, *inputs),
                                    **options))
