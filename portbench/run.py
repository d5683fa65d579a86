"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up (the clock starts when this module starts, before PyTorch is
imported) builds what the cell's driver needs and warms it up; the window
then measures for --seconds; after it, the peak device memory is read, the
program's state is freed, the card's copy rates are probed (probe.py; on
stderr only), and the traffic driver's check() holds what the window
produced to the plain reference. With --trace 0 the result carries the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, read from
a torch.profiler trace of the window and the runner's own counters.

Everything that belongs to one cell is data that this module finds by
name: the configuration in configs/<config>.json, the traffic mix in
traffic/<traffic>.json, its driver in drivers/<driver>.py (named by the
traffic's "driver"), and each metric's reader in metrics/<metric>.py.

Exit codes: 0 with a result line (whose `correct` may be false); 2 with no
result where there is no card or too few; 3 where JAX or the JAX package
was imported; 1 on any other error.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# Modules that may not be loaded in the process that prints the result,
# compared by their whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "gps_sdr_sim_tpu")


@dataclass
class Run:
    """What a metric's reader reads: the cell's name, set-up seconds, the
    traffic driver's window and check, and the reduced trace (None with
    --trace 0). A reader that finds nothing to read in a run returns None,
    and the metric is left out of that run's line."""
    workload: str
    setup_s: float
    window: object
    check: object
    trace: object


def load_spec(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fp:
        return json.load(fp)


def cell(spec: dict, workload: str, root: pathlib.Path = ROOT):
    """(workload entry, configuration, traffic) of cell `workload`."""
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"unknown workload {workload!r}")
    w = found[0]
    with open(root / "portbench" / "configs" / f"{w['config']}.json") as fp:
        cfg = json.load(fp)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as fp:
        traffic = json.load(fp)
    return w, cfg, traffic


def metrics_of(spec: dict, trace: bool) -> list:
    """The metrics whose readers a run calls: the end-to-end ones with
    --trace 0, the per-layer ones with --trace 1."""
    return spec["per_layer"] if trace else spec["end_to_end"]


def reader(name: str, root: pathlib.Path = ROOT):
    """The read(run) function of metrics/<name>.py."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _cache_dirs(root: pathlib.Path) -> None:
    """Kernel caches at fixed paths inside the checkout, for PyTorch's
    extension builder, Triton and the CUDA JIT (the port's own nvcc builds
    go to build/torch_kernels/ beside its package)."""
    base = root / "build" / "portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, root: pathlib.Path = ROOT) -> dict:
    """Run cell `workload` once and return its result line as a dict.
    device None: the first card, which has to be there; a test may pass
    "cpu" to drive the rest of a run with the traffic's plain impl."""
    import torch

    t_torch = time.perf_counter() - _T0
    spec = load_spec(root)
    w, cfg, traffic = cell(spec, workload, root)
    chips = int(w["chips"])
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise NoCard(f"cell {workload} needs {chips} CUDA device(s); "
                         f"found {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    prog = driver.setup(cfg, traffic, root, device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - _T0
    stages = " ".join(f"{k} {v:.3f}" for k, v in prog.stages.items())
    print(f"setup_s {setup_s:.3f}: import_torch {t_torch:.3f} {stages}",
          file=sys.stderr, flush=True)

    tracer = None
    if trace:
        from portbench.trace import Tracer

        tracer = Tracer(device)
    win = driver.window(prog, traffic, seconds, seed, tracer)
    print(win.diagnosis(), file=sys.stderr, flush=True)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.free(prog)
    del prog
    gc.collect()
    if cuda:
        from portbench.probe import rates

        torch.cuda.empty_cache()
        print("probe " + " ".join(f"{k} {v:.3f}"
                                  for k, v in rates(device).items()),
              file=sys.stderr, flush=True)
    summary = tracer.summary() if tracer is not None else None
    checked = driver.check(cfg, traffic, root, win, device)

    run = Run(workload, setup_s, win, checked, summary)
    metrics = {}
    for m in metrics_of(spec, trace):
        value = reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(memory_peak)}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    if cuda:
        from portbench.peaks import card_line

        dev["card"] = card_line(device.index or 0)
    numbers = {name: {"value": v, "limit": lim}
               for name, (v, lim) in checked.numbers.items()}
    correct = checked.failed == 0 and all(
        v <= lim for v, lim in checked.numbers.values())
    line = {"correct": bool(correct), "attempted": checked.attempted,
            "failed": checked.failed, "metrics": metrics, "device": dev}
    if summary is not None:
        line["breakdown"] = {"device_ops": summary.device_ops,
                             "idle_gaps": summary.idle_gaps}
    line["checked"] = numbers
    return line


class NoCard(RuntimeError):
    """The cell's cards are not there."""


def main(argv=None, device=None, root: pathlib.Path = ROOT) -> int:
    """The command. device and root are for the tests: a CPU run of a
    cell's plain impl in a copy of the checkout."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs(root)
    try:
        line = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), device=device, root=root)
    except NoCard as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"ERROR: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, n in line["checked"].items():
        print(f"checked {name} {n['value']} limit {n['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
