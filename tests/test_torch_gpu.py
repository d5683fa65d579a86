"""The hand-written CUDA kernels against their plain PyTorch versions, the
sharded paths on the card, and the receiver (its FFT and int8 searches) on
the card against the CPU.

Needs a CUDA device (a CUDA kernel has no CPU mode), so it skips here.
This file imports no JAX, so on a machine without JAX it runs as
`python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`
(tests/conftest.py imports JAX)."""

import io

import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.ops import synth, synth_closed
from gps_sdr_sim_tpu_torch.ops.plan import plan_batch
from gps_sdr_sim_tpu_torch.parallel import synth_rows_sharded
from gps_sdr_sim_tpu_torch.parallel.mesh import make_mesh
from gps_sdr_sim_tpu_torch.runner import run_simulation
from gps_sdr_sim_tpu_torch.testing import (
    DATA,
    NAV,
    golden_scenario,
    mxu_devices_agree,
    random_wire,
    receiver_devices_agree,
    rx_capture,
    rx_scenario,
)
from gps_sdr_sim_tpu_torch.ops import synth_cuda
from gps_sdr_sim_tpu_torch.tools import profile_kernel, vpu_peak


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", [16, 8, 1])
def test_cuda_kernel_matches_plain_version(fmt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    for seed in range(4):
        wire, ca, n_chan = random_wire(seed, n_epochs=3, max_gain=400)
        w, c = torch.from_numpy(wire).to(dev), torch.from_numpy(ca).to(dev)
        before = synth.launch_counts["synth_wire"]
        got = synth.synth_wire(w, c, n_chan, 5000, fmt)
        assert synth.launch_counts["synth_wire"] == before + 1
        want = synth.synth_wire_ref(w, c, n_chan, 5000, fmt)
        assert torch.equal(got, want), seed


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_at_the_domain_edge():
    """Code steps just below 2 chips per sample: a sub-block reads the most
    sign words the kernel holds, in every output mode and nav variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    wire, ca, n_chan = random_wire(5, n_epochs=3, max_gain=400)
    wire[..., 2:4] = np.full(wire.shape[:2], synth.MAX_CODE_STEP - 1,
                             np.int64).view(np.int32).reshape(
                                 *wire.shape[:2], 2)
    w, c = torch.from_numpy(wire).to(dev), torch.from_numpy(ca).to(dev)
    for nav in (False, True):
        for fmt in (16, 8, 1):
            assert torch.equal(synth.synth_wire(w, c, n_chan, 5000, fmt, nav),
                               synth.synth_wire_ref(w, c, n_chan, 5000, fmt,
                                                    nav))
        for mode in ("planes", "raw"):
            got = getattr(synth, f"synth_wire_{mode}")(w, c, n_chan, 5000,
                                                       nav)
            want = getattr(synth, f"synth_wire_{mode}_ref")(w, c, n_chan,
                                                            5000, nav)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_runner_on_a_card_other_than_the_current_one():
    """cuda:N with N > 0: staging, kernel and readback all go to that card's
    stream, and the writer waits for it, so the bytes equal the CPU run's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    out = {}
    for impl, device in (("cuda", dev), ("torch", "cpu")):
        buf = io.BytesIO()
        run_simulation(golden_scenario("static16"), buf, batch_epochs=1,
                       log=lambda s: None, impl=impl, device=device)
        out[impl] = buf.getvalue()
    assert torch.cuda.current_device() == 0
    assert out["cuda"] == out["torch"]


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["cuda", "cuda-sharded"])
def test_runner_copy_stream_keeps_the_bytes(impl):
    """Each batch is read back on a copy stream beside the next batch's
    synthesis (cuda-sharded on a 1x1 mesh). With one-epoch batches the
    writer's queue fills and the caching allocator hands freed blocks to
    later batches, so a copy that read its piece before the piece was
    written, or a piece reused before its copy had read it, shows as bytes
    unlike the CPU run's; the whole scenario as one batch runs the path
    once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    scn = golden_scenario("circle16", duration=1.0)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(1, 1, [dev]) if impl == "cuda-sharded" else None

    def run(impl, device, batch_epochs, mesh=None):
        buf = io.BytesIO()
        run_simulation(scn, buf, batch_epochs=batch_epochs,
                       log=lambda s: None, impl=impl, device=device,
                       mesh=mesh)
        return buf.getvalue()

    want = run("torch", "cpu", scn.n_output_epochs)
    for batch_epochs in (1, scn.n_output_epochs):
        assert run(impl, dev, batch_epochs, mesh) == want, batch_epochs


@pytest.mark.gpu
def test_fetch_async_waits_for_the_piece_and_keeps_it():
    """fetch_async's copy waits for the piece's writer on the current
    stream, held back here by a sleep, and the piece's memory goes to no
    new tensor before the copy has read it: a tensor of its size is
    allocated and overwritten on the current stream right after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gps_sdr_sim_tpu_torch.runner import fetch_async

    dev = torch.device("cuda", 0)
    n = 1 << 25  # 128 MiB of int32: a copy of about 2 ms
    want = torch.arange(n, dtype=torch.int32)
    src = want.to(dev)
    piece = torch.empty(n, dtype=torch.int32, device=dev)
    copy_stream = torch.cuda.Stream(dev)
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(100_000_000)
    piece.copy_(src)
    host, done = fetch_async(piece, copy_stream)
    del piece
    torch.full((n,), -1, dtype=torch.int32, device=dev)
    done.synchronize()
    assert torch.equal(host, want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["planes", "raw"])
def test_cuda_iq_modes_match_plain_versions(mode):
    """The int16-plane and raw int32 modes, word for word, with gains up to
    400 and t0 = -1 rows, at a width that ends mid sub-block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    fn = getattr(synth, f"synth_wire_{mode}")
    ref = getattr(synth, f"synth_wire_{mode}_ref")
    for seed in range(4):
        wire, ca, n_chan = random_wire(seed, n_epochs=3, max_gain=400)
        w, c = torch.from_numpy(wire).to(dev), torch.from_numpy(ca).to(dev)
        before = synth.launch_counts[f"synth_wire_{mode}"]
        got = fn(w, c, n_chan, 5000)
        assert synth.launch_counts[f"synth_wire_{mode}"] == before + 1
        want = ref(w, c, n_chan, 5000)
        assert got[0].dtype == want[0].dtype
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("cards", [1, 4])
def test_sharded_2x2_matches_one_card(cards):
    """A 2x2 mesh (raw kernel, chan reduction across cards when cards=4)
    writes the bytes of the single-device kernel on one card."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), motion_file=str(DATA / "circle.csv"),
        duration=2.0, samp_freq=2.6e6, data_format=16))
    devs = [torch.device("cuda", i % cards) for i in range(4)]
    out = {}
    for impl, kw in (("cuda", dict(device="cuda:0")),
                     ("cuda-sharded", dict(mesh=make_mesh(2, 2, devs)))):
        buf = io.BytesIO()
        run_simulation(scn, buf, batch_epochs=10, log=lambda s: None,
                       impl=impl, **kw)
        out[impl] = buf.getvalue()
    assert len(out["cuda"]) == scn.n_output_epochs * scn.iq_buff_size * 4
    assert out["cuda-sharded"] == out["cuda"]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["16", "8", "1", "planes", "raw"])
def test_nav_gather_modes_match_plain_versions(mode):
    """The nav mask-table variant of every output mode, word for word, on
    random wires whose t0 = -1 rows read lane 127 of the table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    if mode in ("planes", "raw"):
        name, kw = f"synth_wire_{mode}", {}
    else:
        name, kw = "synth_wire", {"fmt": int(mode)}
    fn, ref = getattr(synth, name), getattr(synth, f"{name}_ref")
    for seed in range(4):
        wire, ca, n_chan = random_wire(seed, n_epochs=3, max_gain=400)
        w, c = torch.from_numpy(wire).to(dev), torch.from_numpy(ca).to(dev)
        before = synth.launch_counts[f"{name}_nav"]
        got = fn(w, c, n_chan, 5000, nav_gather=True, **kw)
        assert synth.launch_counts[f"{name}_nav"] == before + 1
        want = ref(w, c, n_chan, 5000, nav_gather=True, **kw)
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        assert all(torch.equal(g, r) for g, r in zip(got, want)), seed


@pytest.mark.gpu
@pytest.mark.parametrize("cards", [1, 4])
def test_sharded_2x2_nav_gather_matches_one_card(cards, monkeypatch):
    """With GPS_SDR_SIM_NAV_GATHER=1, a 2x2 mesh (the raw kernel's gather
    variant, chan reduction across cards when cards=4) writes the bytes of
    the single-device gather kernel on one card, and on a real plan those
    equal the window walk's."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), motion_file=str(DATA / "circle.csv"),
        duration=2.0, samp_freq=2.6e6, data_format=16))
    devs = [torch.device("cuda", i % cards) for i in range(4)]
    out = {}
    runs = (("walk", "0", "cuda", dict(device="cuda:0")),
            ("cuda", "1", "cuda", dict(device="cuda:0")),
            ("cuda-sharded", "1", "cuda-sharded",
             dict(mesh=make_mesh(2, 2, devs))))
    for label, switch, impl, kw in runs:
        monkeypatch.setenv("GPS_SDR_SIM_NAV_GATHER", switch)
        before = dict(synth.launch_counts)
        buf = io.BytesIO()
        run_simulation(scn, buf, batch_epochs=10, log=lambda s: None,
                       impl=impl, **kw)
        out[label] = buf.getvalue()
        key = {"walk": "synth_wire", "cuda": "synth_wire_nav",
               "cuda-sharded": "synth_wire_raw_nav"}[label]
        assert synth.launch_counts[key] > before[key]
    assert out["cuda-sharded"] == out["cuda"] == out["walk"]


@pytest.mark.gpu
def test_vpu_peak_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    seed, table = vpu_peak.inputs("cuda")
    for case in vpu_peak.CASES:
        before = vpu_peak.launch_counts["vpu_peak"]
        got = vpu_peak.vpu_peak(seed, table, 3, 5, case)
        assert vpu_peak.launch_counts["vpu_peak"] == before + 1
        assert torch.equal(got, vpu_peak.vpu_peak_ref(seed, table, 3, 5,
                                                      case)), case


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", [16, 8, 1])
def test_ablated_kernels_match_plain_versions(fmt):
    """Every ablated instantiation (csrc/synth_profile.cu) = its plain
    version, ops.synth.schedule_words with its ablation set, word for
    word; and each writes other words than the production kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    for seed in range(3):
        wire, ca, n_chan = random_wire(seed, n_epochs=3, max_gain=400)
        w, c = torch.from_numpy(wire).to(dev), torch.from_numpy(ca).to(dev)
        production = synth.synth_wire(w, c, n_chan, 5000, fmt)
        for name, ablate in synth_cuda.ABLATION_SETS.items():
            before = profile_kernel.launch_counts["synth_wire_ablated"]
            got = profile_kernel.synth_wire_ablated(w, c, n_chan, 5000, fmt,
                                                    ablate)
            assert profile_kernel.launch_counts["synth_wire_ablated"] == \
                before + 1
            want = synth.schedule_words(w, c, n_chan, 5000, fmt, ablate)
            assert torch.equal(got, want), (seed, name)
            assert not torch.equal(got, production), (seed, name)


@pytest.mark.gpu
def test_production_library_is_the_production_loop():
    """The ablation mask is 0 in every production instantiation: the
    production library holds exactly its 12 instantiations, each at 18.625
    SASS per (sample, channel) (298 per trip of 16 samples), 72 registers
    and no spills, as before the mask existed (nvcc 12.9)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lib = synth_cuda.build()
    counts = synth_cuda.channel_loop_instructions(synth_cuda.sass_loops(
        synth_cuda.sass(lib)))
    assert sorted(counts) == sorted(synth_cuda.all_instantiation_keys())
    assert set(counts.values()) == {298 / 16}
    usage = [u for fn, u in synth_cuda.ptxas_usage(
        synth_cuda.build_log(lib)).items() if synth_cuda.instantiation_key(fn)]
    assert len(usage) == 12
    assert {(u["registers"], u["spill_stores"], u["spill_loads"])
            for u in usage} == {(72, 0, 0)}


@pytest.mark.gpu
def test_receiver_card_matches_cpu():
    """The receiver's search, acquisition and 1.9 s of tracking on the card
    against the same functions on the CPU, on a capture synthesized by the
    CUDA kernel, within the CPU tests' tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = rx_capture(rx_scenario(2.0), "cuda", "cuda")
    assert receiver_devices_agree(x, "cuda")["channels"] == 13


@pytest.mark.gpu
@pytest.mark.parametrize("fs", [2.048e6, 1.023e6])
def test_acquire_mxu_card_matches_cpu(fs):
    """acquire_mxu's int8 search and results on the card against the CPU,
    on 0.3 s captured by the CUDA kernel; at 1.023 Msps (S = 1023) the
    operands of torch._int_mm are zero-padded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = rx_capture(rx_scenario(0.3, fs=fs), "cuda", "cuda")
    assert mxu_devices_agree(x, fs, "cuda")["channels"] == 13


def _golden_batch(name, n_epochs=3):
    scn = golden_scenario(name)
    return scn, plan_batch(scn.segments[0], 0, n_epochs, scn.iq_buff_size,
                           scn.delt)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["planes", "raw"])
def test_row_kernel_matches_plain_version(mode):
    """The row form, word for word, on real rows (1 Msps: a code step above
    one chip per sample; highalt16: gains above 131) and on the same rows
    with seeded gains up to 400, a third of them 0 (which the prologue
    drops), and t_base = -1 at the first sub-block (T = -1, mg = -1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    fn = getattr(synth, f"synth_rows_{mode}")
    ref = getattr(synth, f"synth_rows_{mode}_ref")
    rng = np.random.default_rng(5)
    for name in ("static16", "highalt16"):
        _, db = _golden_batch(name)
        rows = synth.pack_rows(db)
        mixed = rows.copy()
        gain = rng.integers(1, 401, mixed.shape[:3])
        mixed[..., 11] = np.where(rng.random(gain.shape) < 0.33, 0, gain)
        first = mixed[:, 0, :, 8]
        mixed[:, 0, :, 8] = np.where(rng.random(first.shape) < 0.4, -1,
                                     first)
        ca = torch.from_numpy(db.ca_words).to(dev)
        for r in (rows, mixed):
            r = torch.from_numpy(r).to(dev)
            before = synth.launch_counts[f"synth_rows_{mode}"]
            got = fn(r, ca)
            assert synth.launch_counts[f"synth_rows_{mode}"] == before + 1
            want = ref(r, ca)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                assert torch.equal(g, w), name


@pytest.mark.gpu
@pytest.mark.parametrize("cards", [1, 4])
def test_rows_sharded_2x2_matches_one_card(cards):
    """synth_rows_sharded on a 2x2 mesh (raw row kernel, chan reduction
    across cards when cards=4) = the row kernel's synth_batch on one card
    = the closed form on the CPU."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    scn, db = _golden_batch("circle16", n_epochs=3)
    n = scn.iq_buff_size
    devs = [torch.device("cuda", i % cards) for i in range(4)]
    got = torch.cat([p.cpu() for p in synth_rows_sharded(
        db, n, make_mesh(2, 2, devs))])
    assert torch.equal(got, synth.synth_batch(db, n, "cuda:0").cpu())
    assert torch.equal(got, synth_closed.synth_batch(db, n, "cpu"))


@pytest.mark.gpu
def test_dryrun_multichip_on_one_card_repeated():
    """entry.dryrun_multichip on a 2x2 mesh of four entries of cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gps_sdr_sim_tpu_torch.entry import dryrun_multichip

    before = dict(synth.launch_counts)
    checks = dryrun_multichip(4, [torch.device("cuda", 0)] * 4)
    assert len(checks) == 5
    for key in ("synth_wire_planes", "synth_wire_raw", "synth_rows_planes",
                "synth_rows_raw"):
        assert synth.launch_counts[key] > before[key], key


@pytest.mark.gpu
def test_dayrun_spot_check_on_the_card():
    """The day's block one hour in, through the kernel: the sha256 that
    DAYRUN_r05.json records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json

    from gps_sdr_sim_tpu_torch.testing import ROOT
    from gps_sdr_sim_tpu_torch.tools import dayrun, deepcheck

    want = json.loads((ROOT / "DAYRUN_r05.json").read_text())
    before = synth.launch_counts["synth_wire"]
    run = dayrun.synth_day(deepcheck.static_config(2.6e6, 86400.0),
                           device="cuda", only_blocks=[36000],
                           log=lambda s: None)
    assert synth.launch_counts["synth_wire"] == before + 2  # + the warm-up
    assert run.stats["block_sha256"] == {
        "36000": want["block_sha256"]["36000"]}


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["cuda", "cuda-sharded", "closed"])
def test_bench_passes_on_the_card_match_the_cpu(impl):
    """tools/bench's synthesis and end-to-end passes over 1 s of the
    canonical scenario on cuda:0 give the (sum, nonzero) of its synthesis
    pass with the plain torch impl on the CPU, and the same least batch
    nonzero count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gps_sdr_sim_tpu_torch.ops.quantize import wrap_int32
    from gps_sdr_sim_tpu_torch.tools import bench

    dev = torch.device("cuda", 0)
    mesh = make_mesh(1, 1, [dev]) if impl.endswith("-sharded") else None
    for fmt in (16, 8, 1):
        scn = bench.canonical_scenario(fmt, 1.0)
        want = bench.synthesis_pass(scn, 4, "torch", "cpu")
        got = bench.synthesis_pass(scn, 4, impl, dev, mesh)
        assert (got.checksum, got.nonzero, got.min_batch_nonzero) == (
            want.checksum, want.nonzero, want.min_batch_nonzero), fmt
        sink = bench.ChecksumSink(fmt)
        bench.end_to_end_pass(scn, sink, 4, impl, dev, mesh)
        assert (wrap_int32(sink.sum), sink.nonzero) == (
            want.checksum, want.nonzero), fmt


@pytest.mark.gpu
def test_fuzz_cases_cuda_equal_plain_version(tmp_path):
    """The first two FORCED cases of fuzz_oracle's seed 0 through run_case:
    the CLI with --impl cuda against the CLI with --impl torch on the same
    card standing in for the C oracle give equal bytes and stderr."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from gps_sdr_sim_tpu_torch.tools import fuzz_oracle

    for case in fuzz_oracle.gen_cases(2, 0):
        stand_in = fuzz_oracle.cli_command("torch", "cuda")
        if case["fixed_carr"]:
            stand_in += ["--carrier-phase", "fixed"]
        r = fuzz_oracle.run_case(case, fuzz_oracle.cli_command("cuda", "cuda"),
                                 stand_in, tmp_path, timeout=600)
        assert r["pass"] and r["size_match"] and r["stderr_match"], r
        assert (r["mismatch_fraction"], r["max_delta"]) == (0, 0), r
