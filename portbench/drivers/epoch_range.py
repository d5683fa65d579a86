"""Driver of traffic that writes a scenario's I/Q through the port's runner,
`runner.run_epoch_range`, into the benchmark's sink, in a closed loop.

Set-up builds the scenario (models.scenario.build_scenario) from the
configuration and the traffic's format and sample rate, builds the mesh
that the traffic names on the run's card, and runs one whole pass of the
scenario into a null sink: that loads or builds the kernel's library and
uploads each segment's C/A words once. It then leaves PINNED_BLOCKS
batch-sized blocks in PyTorch's pinned host pool, so nothing of the kind
happens in the window.

The window calls the runner over batch-aligned epoch ranges, one after
another: the first from an epoch that the seed picks to the scenario's end,
then whole passes, until the window's seconds have passed; it counts all
the work over the whole elapsed time. The sink takes a host timestamp at
each write, counts the bytes, and keeps a copy of only the epochs that the
seed picks for the check, about one in `check_stride_epochs`.

The check, once the window has closed: the plain reference (reference/)
works the scenario out again and synthesizes each kept epoch; every byte is
compared, and `wrong_bytes` has the limit 0. A run is also failed for any
epoch attempted and not delivered.
"""

from __future__ import annotations

import pathlib
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

# Each compared number and its limit. The comparison is exact.
LIMITS = {"wrong_bytes": 0}


@dataclass
class Program:
    """What the window drives: run_range(sink, lo, hi) writes output epochs
    [lo, hi) into sink and returns the runner's RunStats or None."""
    run_range: Callable
    n_epochs: int
    epoch_bytes: int
    epoch_s: float
    state: list = field(default_factory=list)
    stages: dict = field(default_factory=dict)   # set-up step: seconds


@dataclass
class Window:
    seconds: float = 0.0
    attempted_epochs: int = 0
    delivered_bytes: int = 0
    epoch_bytes: int = 1
    epoch_s: float = 0.1
    calls: list = field(default_factory=list)      # [(lo, hi)]
    gaps_ms: list = field(default_factory=list)
    kept: list = field(default_factory=list)       # [(epoch, bytes)]
    stats: dict = field(default_factory=dict)
    call_s: list = field(default_factory=list)     # each call's seconds

    def diagnosis(self) -> str:
        """One line for stderr: what a far-off run needs looked at."""
        g = np.percentile(self.gaps_ms, [50, 90, 95, 99, 100]) \
            if len(self.gaps_ms) else [np.nan] * 5
        c = np.percentile(self.call_s, [0, 50, 100]) * 1e3
        b = max(self.stats.get("device_batches", 0), 1)
        return (f"window {self.seconds:.3f} s: {len(self.call_s)} calls of "
                f"{c[0]:.1f}/{c[1]:.1f}/{c[2]:.1f} ms (min/median/max); "
                f"gaps p50/p90/p95/p99/max {'/'.join(f'{x:.3f}' for x in g)}"
                f" ms; plan {1e3 * self.stats.get('plan_seconds', 0) / b:.3f}"
                f" fetch {1e3 * self.stats.get('fetch_seconds', 0) / b:.3f} "
                f"ms a batch")

    @property
    def delivered_epochs(self) -> int:
        return self.delivered_bytes // self.epoch_bytes

    @property
    def signal_s(self) -> float:
        return self.delivered_epochs * self.epoch_s


@dataclass
class Check:
    numbers: dict          # {name: (value, limit)}
    attempted: int
    failed: int
    least_time_s: float    # the window's epochs at the card's peaks


class NullSink:
    def write(self, data) -> int:
        return memoryview(data).nbytes


class Sink:
    """Counts bytes, timestamps each write, and keeps the seed's epochs."""

    def __init__(self, epoch_bytes: int, stride: int, rng, traced: bool):
        self.epoch_bytes = epoch_bytes
        self.stride = max(int(stride), 1)
        self.rng = rng
        self.traced = traced
        self.bytes = 0
        self.kept = []
        self.call_times = []
        self._global = 0
        self._epoch = 0
        self._next_keep = None

    def begin_call(self, lo: int, hi: int) -> None:
        self._epoch = lo
        self.call_times.append([])
        if self._next_keep is None:
            self._next_keep = int(self.rng.integers(
                0, max(min(self.stride, hi - lo), 1)))

    def write(self, data) -> int:
        t = time.perf_counter()
        if self.traced:
            import torch

            from portbench.trace import SINK_SPAN

            with torch.profiler.record_function(SINK_SPAN):
                return self._write(data, t)
        return self._write(data, t)

    def _write(self, data, t: float) -> int:
        mv = memoryview(data).cast("B")
        n = mv.nbytes
        self.call_times[-1].append(t)
        eb = self.epoch_bytes
        k = n // eb
        while self._next_keep < self._global + k:
            i = self._next_keep - self._global
            self.kept.append((self._epoch + i, bytes(mv[i * eb:(i + 1) * eb])))
            self._next_keep += max(1, int(self.rng.integers(
                self.stride // 2, self.stride + self.stride // 2 + 1)))
        self._global += k
        self._epoch += k
        self.bytes += n
        return n


def scenario_config(mod, cfg: dict, traffic: dict, root: pathlib.Path):
    """The ScenarioConfig of `mod` (the port's models.scenario or the
    reference's scenario) for a configuration and a traffic mix; static_llh
    is degrees, degrees, metres, as the CLI's -l takes it."""
    static_xyz = None
    if "static_llh" in cfg:
        lat, lon, hgt = cfg["static_llh"]
        static_xyz = mod.llh2xyz(np.array([lat / mod.R2D, lon / mod.R2D,
                                           hgt]))
    motion = cfg.get("motion_file")
    return mod.ScenarioConfig(
        nav_file=str(root / cfg["nav_file"]),
        motion_file=str(root / motion) if motion else None,
        static_xyz=static_xyz, duration=cfg.get("duration"),
        samp_freq=float(traffic["samp_freq"]),
        data_format=int(traffic["data_format"]),
        iono_enable=bool(cfg.get("iono", True)),
        carrier_phase_mode=cfg.get("carrier_phase_mode", "float"))


def _port_program(cfg, traffic, root, device) -> Program:
    t = time.perf_counter()
    from gps_sdr_sim_tpu_torch.models import scenario
    from gps_sdr_sim_tpu_torch.runner import run_epoch_range

    t1 = time.perf_counter()
    scn = scenario.build_scenario(scenario_config(scenario, cfg, traffic,
                                                  root))
    stages = {"import_port": t1 - t, "scenario": time.perf_counter() - t1}
    impl = traffic["impl"]
    mesh = None
    if impl.endswith("-sharded"):
        from gps_sdr_sim_tpu_torch.parallel.mesh import make_mesh

        n_time, n_chan = traffic["mesh"]
        mesh = make_mesh(n_time, n_chan, [device] * (n_time * n_chan))
    be = int(traffic["batch_epochs"])

    def run_range(sink, lo, hi):
        return run_epoch_range(scn, sink, lo, hi, batch_epochs=be,
                               log=lambda s: None, impl=impl, device=device,
                               mesh=mesh)

    return Program(run_range, scn.n_output_epochs,
                   _epoch_bytes(scn.iq_buff_size, traffic),
                   scn.iq_buff_size / scn.samp_freq, [scn, mesh], stages)


def _epoch_bytes(n_out: int, traffic: dict) -> int:
    from portbench.peaks import output_bytes

    return output_bytes(n_out, int(traffic["data_format"]))


def _segment_batches(scn, lo: int, hi: int, batch_epochs: int):
    """(segment, e0, e1) covering output epochs [lo, hi), batches cut at
    segment ends, as the runner cuts them."""
    for seg in scn.segments:
        s0 = seg.first_epoch - 1
        e, end = max(lo, s0) - s0, min(hi, s0 + seg.n_epochs) - s0
        while e < end:
            yield seg, e, min(e + batch_epochs, end)
            e = min(e + batch_epochs, end)


def _reference_program(cfg, traffic, root, device,
                       precision: str) -> Program:
    """The control: the plain reference in the program's place, computing
    every batch the window asks for at `precision`."""
    import torch

    from portbench.reference import scenario as rs
    from portbench.reference import synth as rsyn
    from portbench.reference.plan import plan_epochs

    rscn = rs.build_scenario(scenario_config(rs, cfg, traffic, root))
    fmt = int(traffic["data_format"])
    be = int(traffic["batch_epochs"])

    def run_range(sink, lo, hi):
        for seg, e0, e1 in _segment_batches(rscn, lo, hi, be):
            eb = plan_epochs(rsyn.rounded(seg, precision), e0, e1, rscn.delt)
            iq = rsyn.iq_epochs(eb, rscn.iq_buff_size, device)
            sink.write(rsyn.pack(iq, fmt).cpu().numpy().reshape(-1).data)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        return None

    return Program(run_range, rscn.n_output_epochs,
                   _epoch_bytes(rscn.iq_buff_size, traffic),
                   rscn.iq_buff_size / rscn.samp_freq, [rscn])


def setup(cfg: dict, traffic: dict, root: pathlib.Path, device,
          program: str = "port") -> Program:
    """The program under test ("port"), or the control ("float32-reference")
    in its place, ready for the window: warmed up by one whole pass."""
    if program == "port":
        prog = _port_program(cfg, traffic, root, device)
    elif program == "float32-reference":
        prog = _reference_program(cfg, traffic, root, device, "float32")
    else:
        raise ValueError(f"unknown program {program!r}")
    if program == "port":
        t = time.perf_counter()
        prog.run_range(NullSink(), 0, prog.n_epochs)
        _fill_pinned_pool(prog, traffic, device)
        prog.stages["warm_up"] = time.perf_counter() - t
    return prog


# Pinned host blocks of a batch's readback that set-up leaves in PyTorch's
# pinned pool: more than the runner holds at once (its queue of 4, the batch
# being enqueued, and freed blocks that wait for the work queued behind
# them), so that no cudaHostAlloc falls in the window (traced windows
# showed one of ~20 ms after a one-pass warm-up alone).
PINNED_BLOCKS = 16


def _fill_pinned_pool(prog: Program, traffic: dict, device) -> None:
    import torch

    if torch.device(device).type != "cuda":
        return
    size = prog.epoch_bytes * int(traffic["batch_epochs"])
    blocks = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
              for _ in range(PINNED_BLOCKS)]
    del blocks


def window(prog: Program, traffic: dict, seconds: float, seed: int,
           tracer=None) -> Window:
    """Drive prog for `seconds` (checked between calls of the runner)."""
    import torch

    rng = np.random.default_rng(seed % 2**64)
    be = int(traffic["batch_epochs"])
    n = prog.n_epochs
    lo = be * int(rng.integers(0, -(-n // be)))
    sink = Sink(prog.epoch_bytes, int(traffic["check_stride_epochs"]), rng,
                traced=tracer is not None)
    win = Window(epoch_bytes=prog.epoch_bytes, epoch_s=prog.epoch_s)
    totals = dict(plan_seconds=0.0, fetch_seconds=0.0, write_seconds=0.0,
                  device_batches=0)
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter()
    while True:
        t_call = time.perf_counter()
        sink.begin_call(lo, n)
        if tracer is not None:
            from portbench.trace import CALL_SPAN

            with torch.profiler.record_function(CALL_SPAN):
                stats = prog.run_range(sink, lo, n)
        else:
            stats = prog.run_range(sink, lo, n)
        win.calls.append((lo, n))
        win.call_s.append(time.perf_counter() - t_call)
        win.attempted_epochs += n - lo
        if stats is not None:
            for k in totals:
                totals[k] += getattr(stats, k)
        lo = 0
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    win.seconds = time.perf_counter() - t0
    if tracer is not None:
        tracer.stop(win.seconds)
    win.delivered_bytes = sink.bytes
    win.kept = sink.kept
    win.gaps_ms = [1e3 * g for times in sink.call_times
                   for g in np.diff(times)]
    win.stats = totals
    return win


def free(prog: Program) -> None:
    prog.state.clear()
    prog.run_range = None


def check(cfg: dict, traffic: dict, root: pathlib.Path, win: Window,
          device) -> Check:
    """Hold the kept epochs to the plain reference, byte for byte."""
    from portbench.peaks import epoch_least_seconds
    from portbench.reference import scenario as rs
    from portbench.reference import synth as rsyn

    rscn = rs.build_scenario(scenario_config(rs, cfg, traffic, root))
    fmt = int(traffic["data_format"])
    ref = {}
    wrong = bad = 0
    for epoch, data in win.kept:
        if epoch not in ref:
            ref[epoch] = rsyn.epoch_bytes(rscn, epoch, device, fmt)
        want = np.frombuffer(ref[epoch], np.uint8)
        got = np.frombuffer(data, np.uint8)
        w = int(np.count_nonzero(got != want)) if got.size == want.size \
            else want.size
        wrong += w
        bad += w > 0
    short = win.attempted_epochs - win.delivered_epochs
    stray = win.delivered_bytes % win.epoch_bytes != 0
    failed = bad + abs(short) + int(stray) + int(not win.kept)
    gains = np.concatenate([
        np.count_nonzero(seg.gain * seg.active[None, :], axis=1)
        for seg in rscn.segments])
    least = epoch_least_seconds(gains, rscn.iq_buff_size, fmt)
    least_time = float(sum(least[lo:hi].sum() for lo, hi in win.calls))
    return Check({"wrong_bytes": (wrong, LIMITS["wrong_bytes"])},
                 win.attempted_epochs, failed, least_time)
