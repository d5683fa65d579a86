"""Named host spans of the runner and the synthesis path, on exactly while a
torch profiler records.

While a profiler records (the CLI's --profile, or any torch.profiler.profile
around a run), span(name) opens a profiler range of that name, so the span
lands on the profiler's timeline beside the device's events, and logs its
duration in memory; totals() sums the log by name. While none records,
span() hands back one shared no-op: no clock read, no profiler event, no
allocation. A region that its caller times anyway (the runner's RunStats
regions) opens its range with begin() and closes it with end() on the
caller's own clock reads.

The ranges are torch._C._profiler._RecordFunctionFast where this PyTorch
has it (RANGE), else torch.profiler.record_function. A range given a batch
(runner.plan, runner.fetch, runner.write: the batch's sequence number
within a runner call) carries it as the keyword argument `batch`, which an
exported trace shows where the profiler records shapes; the log keys by
name alone. Recording follows the profiler's process-wide flag, so spans
opened on other threads (the day run's producer and collector) are logged
too; the profiler draws only those of the threads it follows.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.autograd.profiler as _profiler

# Every span the program opens. Per batch, inside runner.plan: the planner
# (plan.plan_epochs, or plan.plan_batch on the closed impls, then
# plan.pad_epochs) and the enqueue (plan.pack_epoch_wire, synth.upload,
# synth.launch, shard.stack, quantize.pack, runner.fetch_async); then, when
# the batch leaves the runner's queue, runner.fetch (the wait on its
# readback) and runner.write (the sink's write). runner.drain is a call's
# final flush loop; runner.run the whole call.
NAMES = (
    "runner.run",
    "runner.plan",
    "plan.plan_epochs",
    "plan.plan_batch",
    "plan.pad_epochs",
    "plan.pack_epoch_wire",
    "synth.upload",
    "synth.launch",
    "shard.stack",
    "quantize.pack",
    "runner.fetch_async",
    "runner.fetch",
    "runner.write",
    "runner.drain",
)

RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)
if RANGE is None:
    RANGE = torch.profiler.record_function

    def _range(name: str, batch):
        return RANGE(name, None if batch is None else str(batch))
else:
    def _range(name: str, batch):
        if batch is None:
            return RANGE(name)
        return RANGE(name, [], {"batch": batch})

_KNOWN = frozenset(NAMES)
_clock = time.perf_counter_ns
# (name, nanoseconds) of each span closed since reset(): appended, copied
# and cleared by single list operations, each atomic whichever thread runs
# it; totals() sums it by name.
_log: list = []
_OFF = contextlib.nullcontext()


def begin(name: str, batch=None):
    """The profiler range `name`, entered, while a profiler records; else
    None. Close it with end()."""
    if not _profiler._is_profiler_enabled:
        return None
    if name not in _KNOWN:
        raise ValueError(f"undeclared span {name!r}")
    rng = _range(name, batch)
    rng.__enter__()
    return rng


def end(rng, name: str, ns: int) -> None:
    """Close a range that begin() opened (nothing for None) and log `ns`
    nanoseconds under `name`."""
    if rng is None:
        return
    rng.__exit__(None, None, None)
    _log.append((name, ns))


class _Span:
    __slots__ = ("name", "_rng", "_t0")

    def __init__(self, name: str, rng):
        self.name = name
        self._rng = rng

    def __enter__(self):
        self._rng.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        ns = _clock() - self._t0
        self._rng.__exit__(None, None, None)
        _log.append((self.name, ns))
        return False


def span(name: str, batch=None):
    """A context manager: the span `name` while a profiler records (timed
    on time.perf_counter_ns), else the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if name not in _KNOWN:
        raise ValueError(f"undeclared span {name!r}")
    return _Span(name, _range(name, batch))


def totals() -> dict:
    """{name: (count, seconds)} of every span closed since reset()."""
    table = {}
    for name, ns in list(_log):
        count, total = table.get(name, (0, 0))
        table[name] = (count + 1, total + ns)
    return {k: (c, ns / 1e9) for k, (c, ns) in table.items()}


def reset() -> None:
    _log.clear()
