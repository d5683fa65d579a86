"""Entry points of a compile check and a multi-device dry run.

Counterpart of the repository's root __graft_entry__.py.

entry(device) returns the closed form of the synthesis
(ops.synth_closed.synth_iq16) as a forward function, with example tensors
on `device`: two real planned epochs of the bundled static scenario (Tokyo,
brdc3540.14n) at 1 Msps.

dryrun_multichip(n) builds a (time x chan) mesh of n entries and runs one
sharded synthesis step of every sharded form, checking each against the
one-device result byte for byte: the closed form sharded (its chan axis
adds the raw partial sums before quantization), the row kernel on a
time-only mesh and on the chan axis, and the wire kernel's sharded path.
The entries may repeat one device (parallel/mesh.py): the CPU, or one card.

    python -m gps_sdr_sim_tpu_torch.entry [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import functools
from typing import Optional, Sequence

import torch

from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.ops import synth, synth_closed
from gps_sdr_sim_tpu_torch.ops.plan import pad_epochs, plan_batch, plan_epochs
from gps_sdr_sim_tpu_torch.parallel import (
    make_mesh,
    synth_batch_sharded,
    synth_epochs_sharded,
    synth_rows_sharded,
)
from gps_sdr_sim_tpu_torch.parallel.mesh import local_devices
from gps_sdr_sim_tpu_torch.testing import NAV, TOKYO


def _tiny_scenario(n_epochs: int):
    """The bundled static scenario at 1 Msps, long enough for `n_epochs`
    output epochs in its first segment."""
    return build_scenario(ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO, duration=0.1 * (n_epochs + 1),
        samp_freq=1.0e6))


def _tiny_batch(n_epochs: int):
    """(scenario, DeviceBatch of its first `n_epochs` epochs)."""
    scn = _tiny_scenario(n_epochs)
    seg = scn.segments[0]
    db = plan_batch(seg, 0, min(n_epochs, seg.n_epochs), scn.iq_buff_size,
                    scn.delt)
    return scn, db


def entry(device="cuda"):
    """(forward function, example tensors on `device`): forward(*args) is
    the [2, iq_buff_size, 2] int16 I/Q of two epochs."""
    scn, db = _tiny_batch(2)
    forward = functools.partial(synth_closed.synth_iq16,
                                n_out=scn.iq_buff_size)
    return forward, synth_closed.batch_tensors(db, torch.device(device))


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> list:
    """One sharded synthesis step of each sharded form on an
    (n_devices / n_chan) x n_chan mesh over the first n_devices entries of
    `devices` (default: every card; entries may repeat a device), each
    equal to the one-device result byte for byte; n_chan is 2 when
    n_devices is even, else 1. Returns the labels of the checks, all of
    which held; raises AssertionError for one that did not, ValueError for
    fewer entries than n_devices."""
    devices = list(local_devices("cuda") if devices is None else devices)
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    devices = [torch.device(d) for d in devices[:n_devices]]
    n_chan = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices // n_chan, n_chan, devices)
    n_time = n_devices // n_chan
    dev = devices[0]

    scn, db = _tiny_batch(n_time)
    n = scn.iq_buff_size
    closed = synth_closed.synth_batch(db, n, dev)
    seg = scn.segments[0]
    eb = pad_epochs(plan_epochs(seg, 0, min(n_time, seg.n_epochs), scn.delt),
                    n_time)
    wire = torch.stack([p[:, :n] for p in synth.synth_wire_planes(
        *synth.stage_epochs(eb, dev), n)], dim=-1)

    checks = {
        f"closed-sharded {n_time}x{n_chan} = closed":
            (synth_batch_sharded(db, n, mesh), closed),
        f"row-sharded {n_devices}x1 = closed":
            (synth_rows_sharded(db, n, make_mesh(n_devices, 1, devices)),
             closed),
    }
    if n_chan > 1:
        checks[f"row-sharded {n_time}x{n_chan} = closed"] = (
            synth_rows_sharded(db, n, mesh), closed)
    checks[f"wire-sharded {n_time}x{n_chan} = wire"] = (
        synth_epochs_sharded(eb, n, mesh), wire)
    checks["wire = closed"] = ([wire[:closed.shape[0]]], closed)
    for label, (pieces, want) in checks.items():
        got = torch.cat([p.to(dev) for p in pieces])
        if not torch.equal(got, want):
            raise AssertionError(f"dryrun_multichip({n_devices}): {label} "
                                 f"fails")
    return list(checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_sim_tpu_torch.entry",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default): the dry run's 8 entries cycle "
                         "over every card; cpu: 8 entries of the CPU")
    ns = ap.parse_args(argv)
    device = torch.device(ns.device)
    fn, args = entry(device)
    out = fn(*args)
    print(f"entry: {tuple(out.shape)} {out.dtype}, max |sample| "
          f"{int(out.abs().max())}")
    cards = local_devices(device.type)
    checks = dryrun_multichip(8, [cards[i % len(cards)] for i in range(8)])
    print(f"dryrun_multichip(8): OK ({'; '.join(checks)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
