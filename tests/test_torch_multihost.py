"""A real multi-process run of the port: two CLI processes joined in a
torch.distributed gloo group on 127.0.0.1.

Each process writes its own time-shards (parallel/writer.py interleaves
shard indices by rank); --concat waits at the group's barrier and rank 0
assembles the file, which must equal a single-process run byte for byte.
The counterpart of tests/test_multihost.py, on the CPU with the kernel's
plain version."""

import os
import socket
import subprocess
import sys

from gps_sdr_sim_tpu_torch.parallel.writer import Manifest
from gps_sdr_sim_tpu_torch.testing import ROOT

ARGS = ["-e", "data/brdc3540.14n", "-l", "35.681298,139.766247,10.0",
        "-d", "0.8", "-s", "1000000", "--impl", "torch", "--device", "cpu",
        "--batch-epochs", "2"]
TIMEOUT = 240  # a rendezvous that never completes must not hang the suite


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(*args):
    return [sys.executable, "-m", "gps_sdr_sim_tpu_torch.cli", *ARGS, *args]


def test_two_process_sharded_run_matches_single(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["OMP_NUM_THREADS"] = "1"  # three processes share the test's cores
    single = tmp_path / "single.bin"
    subprocess.run(_cli("-o", str(single)), cwd=ROOT, env=env, check=True,
                   capture_output=True, timeout=TIMEOUT)

    port = _free_port()
    shard_dir = tmp_path / "shards"
    multi = tmp_path / "multi.bin"
    procs = [subprocess.Popen(
        _cli("-o", str(multi), "--shard-dir", str(shard_dir), "--shards",
             "4", "--concat", "--multihost", f"127.0.0.1:{port},{rank},2"),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err.decode()
    finally:
        for p in procs:
            p.kill()
            p.wait()

    manifest = Manifest.load(str(shard_dir / "manifest.json"))
    assert len(manifest.shards) == 4
    assert single.stat().st_size == 7 * 100000 * 4  # 7 output epochs
    assert multi.read_bytes() == single.read_bytes()
