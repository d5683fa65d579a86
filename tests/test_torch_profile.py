"""The kernel cost-attribution tools on the CPU: the ablated variants' plain
versions, tools/profile_kernel and tools/op_budget.

- ops.synth.schedule_words / schedule_sums with no ablation equal the
  production plain version (synth_wire_ref) in every format, on seeded
  random wires and on a real plan;
- the no_nav_walk plain model equals the Pallas kernel run by the
  interpreter with ablate={"no_nav_walk"}, as tools/profile_kernel.py
  builds it: both compute the C/A-only signal. The other stand-ins are tied
  to each kernel's own layout, so each plain model is held to a direct
  NumPy evaluation of its definition instead;
- profile_kernel --cpu prints one JSON line of PROFILE_r05.json's keys,
  and its noise rule reports deltas below the rep-to-rep spread as null;
- op_budget's SASS classes and body/setup split on a handwritten Hopper
  SASS rolled loop, and the whole tool on such text with --cpu;
- both tools exit 1 without a card and without --cpu;
- only tools/profile_kernel.py, tools/op_budget.py and chip_smoke.py reach
  the ablated launcher (an AST scan).
The ablated CUDA kernels themselves are held to these plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py phase 16)."""

import ast
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu.ops import synth_pallas
from gps_sdr_sim_tpu_torch.constants import SUBBLOCK
from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.ops import synth, synth_cuda
from gps_sdr_sim_tpu_torch.ops.plan import pack_epoch_wire, plan_epochs
from gps_sdr_sim_tpu_torch.ops.tables import COS_TABLE512, SIN_TABLE512
from gps_sdr_sim_tpu_torch.testing import NAV, ROOT, TOKYO, random_wire
from gps_sdr_sim_tpu_torch.tools import op_budget, profile_kernel

PKG = ROOT / "gps_sdr_sim_tpu_torch"
MASK40 = (1 << 40) - 1


@pytest.fixture
def one_torch_thread(monkeypatch):
    """torch on one thread (ROADMAP C3: small ops stall on contended
    intra-op threads when several test processes share the cores)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _real_plan(epochs=2, samp_freq=1.0e6):
    """Epochs of Tokyo static at 1 Msps: wire, C/A words, batch, n_out."""
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO, duration=0.1 * (epochs + 2),
        samp_freq=samp_freq))
    eb = plan_epochs(scn.segments[0], 0, epochs, scn.delt)
    return pack_epoch_wire(eb), eb.ca_words, eb, scn.iq_buff_size


# ---------------------------------------------------------------------------
# The plain versions.
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("fmt", [16, 8, 1])
@pytest.mark.parametrize("source", ["random", "real"])
def test_unablated_schedule_words_equal_the_plain_version(source, fmt):
    if source == "real":
        wire, ca, _, n_out = _real_plan()
        cases = [(wire, ca, 3, n_out)]
    else:
        cases = []
        for seed in range(3):
            wire, ca, n_chan = random_wire(seed, n_epochs=2, max_gain=400)
            cases.append((wire, ca, n_chan, 5000))
    for wire, ca, n_chan, n_out in cases:
        w, c = torch.from_numpy(wire), torch.from_numpy(ca)
        got = synth.schedule_words(w, c, n_chan, n_out, fmt)
        assert torch.equal(got, synth.synth_wire_ref(w, c, n_chan, n_out,
                                                     fmt))


@pytest.mark.usefixtures("one_torch_thread")
def test_no_nav_walk_matches_pallas_interpret():
    """The JAX kernel's stand-in is dsign = -ca_bit, the port's sign words
    carry every nav bit as 0: both are the C/A-only signal, at SC16."""
    wire, ca, eb, n_out = _real_plan(epochs=1)
    n_chan = 2
    ablate = frozenset({"no_nav_walk"})
    sub_blocks = -(-n_out // SUBBLOCK)
    tile, sb_pad = synth_pallas._aligned_tile(sub_blocks)
    inner = synth_pallas._get_pallas_fn(
        n_chan, uniform=True, tile_rows=tile,
        premult=synth_pallas.premult_ok(eb.gain),
        int_step=bool(np.any(eb.code_s >> 56)), fmt=16, ablate=ablate)
    params, _rows = synth_pallas._wire_to_params(jnp.asarray(wire),
                                                 sub_blocks, align=True)
    want = np.asarray(inner(params, jnp.asarray(ca))).reshape(
        wire.shape[0], sb_pad * SUBBLOCK)[:, :sub_blocks * SUBBLOCK]
    w, c = torch.from_numpy(wire), torch.from_numpy(ca)
    got = synth.schedule_words(w, c, n_chan, n_out, 16, ablate)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not torch.equal(got, synth.schedule_words(w, c, n_chan, n_out,
                                                     16))


def _lanes(wire, b, c, lane):
    """The unsigned 64-bit value of lanes (lane, lane + 1), a Python int."""
    lo, hi = (int(x) & 0xFFFFFFFF for x in wire[b, c, lane:lane + 2])
    return lo | (hi << 32)


def _numpy_sums(wire, ca, n_chan, sub_blocks, ablate):
    """Channel sums (I, Q), int64 [B, SB, SUBBLOCK], straight from the
    stand-ins' definitions (csrc/synth.cu Ablate): per (sample, channel)
    the sign is C/A bit xor nav bit (no_nav_walk: the C/A bit alone;
    no_ca_gather: bit 0 of the whole chips since the sub-block's first
    sample) and the pair is gain * +-(cos, sin) of the table index
    (no_trig_gather: gain * (2 * index + sign) in both)."""
    B = wire.shape[0]
    r = np.arange(SUBBLOCK, dtype=np.int64)
    ca32 = ca.astype(np.int64) & 0xFFFFFFFF
    out = np.zeros((2, B, sub_blocks, SUBBLOCK), np.int64)
    for b in range(B):
        for sb in range(sub_blocks):
            k0 = sb * SUBBLOCK
            for c in range(n_chan):
                gain = int(wire[b, c, 11])
                if gain == 0:
                    continue
                ramps = []
                for lane in (0, 4):
                    f, s = _lanes(wire, b, c, lane), _lanes(wire, b, c,
                                                            lane + 2)
                    lo = (f & 0xFFFF) + k0 * (s & 0xFFFF)
                    hi = (f >> 16) + k0 * (s >> 16) + (lo >> 16)
                    ramps.append((hi & MASK40, hi >> 40, s >> 16))
                (cb, carry, cs), (pb, _, ps) = ramps
                chips = (cb + r * cs) >> 40
                T = int(wire[b, c, 8]) + carry + chips
                M = T // 1023
                chip = T - 1023 * M
                ca_bit = (ca32[c][chip >> 5] >> (chip & 31)) & 1
                m0, b0 = int(wire[b, c, 9]) & 0xFFFF, int(wire[b, c, 9]) >> 16
                j = (m0 - 20 * b0 + M) // 20
                nb = int(wire[b, c, 10])
                nav = np.where((j < 0) | (j > 31), nb >> 31,
                               nb >> np.clip(j, 0, 31)) & 1
                if "no_nav_walk" in ablate:
                    nav = 0
                sign = chips & 1 if "no_ca_gather" in ablate else ca_bit ^ nav
                idx = ((pb + r * ps) >> 31) & 0x1FF
                if "no_trig_gather" in ablate:
                    out[:, b, sb] += gain * (2 * idx + sign)
                else:
                    out[0, b, sb] += gain * (1 - 2 * sign) * COS_TABLE512[idx]
                    out[1, b, sb] += gain * (1 - 2 * sign) * SIN_TABLE512[idx]
    return out


@pytest.mark.parametrize("name", sorted(synth_cuda.ABLATION_SETS))
def test_stand_ins_match_their_definitions(name):
    """A 1-epoch, 2-channel wire (t0 = -1 rows included), 3 sub-blocks."""
    ablate = synth_cuda.ABLATION_SETS[name]
    for seed in (0, 1):
        wire, ca, _ = random_wire(seed, n_epochs=1, n_chan=2, max_gain=400)
        wire[..., 11] = np.maximum(wire[..., 11], 1)
        got = synth.schedule_sums(torch.from_numpy(wire),
                                  torch.from_numpy(ca), 2, 3, ablate=ablate)
        want = _numpy_sums(wire, ca, 2, 3, ablate)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), x)


def test_ablation_names_mirror_the_kernel():
    """The Ablate bits of csrc/synth.cu, and the four sets that
    csrc/synth_profile.cu launches, are synth_cuda's."""
    src = synth_cuda.SOURCE.read_text()
    enum = re.search(r"enum Ablate \{([^}]*)\}", src).group(1)
    bits = {m[0]: int(m[1]) for m in re.findall(r"k(\w+) = (\d+)", enum)}
    assert bits == {"NoTrigGather": 1, "NoCaGather": 2, "NoNavWalk": 4}
    assert synth_cuda.ABLATE_BITS == {"no_trig_gather": 1,
                                      "no_ca_gather": 2, "no_nav_walk": 4}
    profile = synth_cuda.PROFILE_SOURCE.read_text()
    cases = re.findall(r"case (k\w+(?: \| k\w+)?):", profile)
    assert cases == ["kNoTrigGather", "kNoCaGather", "kNoNavWalk",
                     "kNoTrigGather | kNoCaGather"]
    assert sorted(synth_cuda.ablate_mask(s) for s in
                  synth_cuda.ABLATION_SETS.values()) == [1, 2, 3, 4]
    for bad in (frozenset(), {"no_nav_walk", "no_ca_gather"}, {"tree"}):
        with pytest.raises(ValueError, match="is not one of"):
            synth_cuda.ablate_mask(bad)
    with pytest.raises(ValueError, match="unknown ablation"):
        synth.schedule_sums(torch.zeros((1, 1, 12), dtype=torch.int32),
                            torch.zeros((1, 32), dtype=torch.int32), 1, 1,
                            ablate={"no_nav_gather"})


def test_profile_library_is_rebuilt_when_synth_cu_changes(tmp_path):
    """The profile library's name hashes the file it includes too."""
    for src in (synth_cuda.SOURCE, synth_cuda.PROFILE_SOURCE):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    profile = tmp_path / synth_cuda.PROFILE_SOURCE.name
    before = synth_cuda.library_path(profile)
    assert before.name.startswith("synth_profile_")
    assert before.name == synth_cuda.library_path(
        synth_cuda.PROFILE_SOURCE).name
    with open(tmp_path / "synth.cu", "a") as fp:
        fp.write("// edited\n")
    assert synth_cuda.library_path(profile) != before


# ---------------------------------------------------------------------------
# profile_kernel.
# ---------------------------------------------------------------------------

PROFILE_KEYS = {"metric", "overhead_separation", "method", "backend", "rows",
                "breakdown", "epilogue"}


@pytest.mark.usefixtures("one_torch_thread")
def test_profile_kernel_cpu_plumbing(tmp_path, capsys):
    out = tmp_path / "profile.json"
    assert profile_kernel.main([
        "--cpu", "--batch-epochs", "2", "--passes", "1", "--reps", "2",
        "--samp-freq", "1e6", "--json", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line, full = json.loads(lines[0]), json.loads(out.read_text())
    assert PROFILE_KEYS - {"rows"} <= set(line) and "rows" not in line
    assert PROFILE_KEYS <= set(full)
    assert {k: v for k, v in full.items() if k != "rows"} == line
    assert line["metric"] == "kernel_cost_attribution"
    assert line["backend"] == "cpu" and line["card"] is None
    assert sorted(full["rows"]) == sorted(profile_kernel.VARIANTS)
    assert all(len(r["reps_s"]) == 2 for r in full["rows"].values())
    assert line["overhead_separation"]["batch_sizes_epochs"] == [1, 2, 4]
    # The noise rule, read back from the rows.
    best = {k: r["best_s"] for k, r in full["rows"].items()}
    reps = full["rows"]["full"]["reps_s"]
    noise = max(reps) - min(reps)
    delta = {c: best["full"] - best[f"no_{c}"]
             for c in ("trig_gather", "ca_gather", "nav_walk")}
    vacuous = (best["full"] - best["no_gathers"] < noise
               or max(delta["trig_gather"], delta["ca_gather"]) < noise)
    brk = line["breakdown"]
    assert brk["additivity_vacuous_below_noise"] == vacuous
    assert (brk["gather_additivity_check"] is None) == vacuous
    for c, d in delta.items():
        null = d < noise or (vacuous and c != "nav_walk")
        assert (brk[f"{c}_ns_per_chan_sample"] is None) == null, c


def test_breakdown_reports_deltas_below_the_noise_as_null():
    reps = [1.000, 1.010, 1.004]  # 10 ms spread
    best = {"full": 1.0, "no_trig_gather": 0.80, "no_ca_gather": 0.90,
            "no_nav_walk": 0.995, "no_gathers": 0.70, "full_sc08": 1.004,
            "full_sc01": 1.1}
    brk, epi = profile_kernel.breakdown(best, reps, 10**9, 10**8, 25e9)
    assert brk["nav_walk_ns_per_chan_sample"] is None
    assert brk["nav_walk_equiv_alu_ops"] is None
    assert brk["trig_gather_ns_per_chan_sample"] == pytest.approx(0.2)
    assert brk["ca_gather_ns_per_chan_sample"] == pytest.approx(0.1)
    assert brk["gather_additivity_check"] == pytest.approx(1.0)
    assert brk["trig_gather_equiv_alu_ops"] == pytest.approx(5.0)
    assert brk["full_equiv_ops_per_chan_sample"] == pytest.approx(25.0)
    assert not brk["additivity_vacuous_below_noise"]
    assert epi == {"sc08_extra_ns_per_sample": None,
                   "sc01_extra_ns_per_sample": pytest.approx(1.0)}
    # A joint delta below the noise makes every gather figure null.
    best.update(no_gathers=0.995, no_ca_gather=0.997)
    brk, _ = profile_kernel.breakdown(best, reps, 10**9, 10**8)
    assert brk["additivity_vacuous_below_noise"]
    for key in ("trig_gather_ns_per_chan_sample",
                "ca_gather_ns_per_chan_sample", "gather_share_of_kernel",
                "gather_additivity_check", "gathers_total_ns_per_chan_sample",
                "gathers_total_share_of_kernel"):
        assert brk[key] is None, key
    assert "alu_equiv_ops_per_chan_sample" not in brk


@pytest.mark.parametrize("tool", [profile_kernel, op_budget])
def test_tools_need_a_card_without_cpu(monkeypatch, capsys, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_ablated_wrapper_refuses_the_production_set():
    wire, ca, n_chan = random_wire(0, n_epochs=1)
    with pytest.raises(ValueError, match="is not one of"):
        profile_kernel.synth_wire_ablated(
            torch.from_numpy(wire), torch.from_numpy(ca), n_chan, 5000, 16,
            frozenset())


# ---------------------------------------------------------------------------
# op_budget.
# ---------------------------------------------------------------------------

# One sample of the channel loop, as nvcc lays it out for the production
# kernel: the phase step (code fraction and chip count: 3 adds; carrier:
# 2), the sign word's index, load and funnel shift, the table index, the
# pair's load and the two gain products.
STEP = ["IADD3 R8, P0, R8, R9, RZ", "IADD3.X R10, R10, R11, RZ, P0, !PT",
        "IADD3.X R12, R12, R13, RZ, P0, !PT", "IADD3 R14, P1, R14, R15, RZ",
        "IADD3.X R16, R16, R17, RZ, P1, !PT"]
SAMPLE = ["SHF.R.U32.HI R18, RZ, 0x5, R12", "LDS R19, [R18.X4+0x1000]",
          "SHF.R.W.U32 R19, R19, R12, R19",
          "LOP3.LUT R20, R19, 0x1, R21, 0xf8, !PT",
          "LDS.64 R22, [R20.X8]", "IMAD R24, R5, R22, R24",
          "IMAD R25, R5, R23, R25"]
SETUP = ["LDS.128 R4, [UR4+0x20]", "LDS.128 R8, [UR4+0x30]",
         "LDS.64 R12, [UR4+0x40]", "IMAD.WIDE.U32 R2, R0, R6, R4",
         "IMAD R3, R0, R7, R3", "SHF.L.U64.HI R9, R2, 0x18, R3",
         "IMAD.SHL.U32 R8, R2, 0x1000000, RZ", "IMAD.MOV.U32 R26, RZ, RZ, R9",
         "IADD3 R1, R1, 0x1, RZ"]
TAIL = ["ISETP.GE.AND P0, PT, R1, R27, PT"]


def _kernel_sass(name, samples=synth_cuda.SAMPLES_PER_TRIP):
    """A synthesis kernel in cuobjdump -sass's layout: a prologue loop (a
    sign word's build, short), then the rolled channel loop (setup, the
    first sample without the phase step, the others with it, the loop
    test and its backward branch), then the epilogue's store."""
    prologue = ["LDG.E R3, [R4.64]", "STS [R5], R3", "IADD3 R6, R6, 0x1, RZ",
                "ISETP.NE.AND P1, PT, R6, 0x4, PT"]
    loop = SETUP + SAMPLE + (STEP + SAMPLE) * (samples - 1) + TAIL
    ops = ["MOV R1, c[0x0][0x28]", *prologue, "@P1 BRA 0x10"]
    top = len(ops)
    ops += loop + [f"@P0 BRA {hex(16 * top)}", "STG.E [R2.64], R24",
                   "EXIT"]
    ops.append(f"BRA {hex(16 * len(ops))}")
    return "\n".join([f"        Function : {name}"] + [
        f"        /*{16 * i:04x}*/                   {op} ;"
        for i, op in enumerate(ops)]) + "\n"


def _ptxas(name):
    return (f"ptxas info    : Function properties for {name}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\nptxas info    : Used 72 registers, used 1 barriers, "
            "17540 bytes smem\n")


def _library_texts():
    """{library: (SASS, -Xptxas -v)} with every instantiation of both."""
    prod = [f"_ZN12_GLOBAL__N_117synth_wire_kernelILi{m}ELi{f}ELb{nav}EEEv"
            f"PKiS2_S2_PiS3_ii" for m, f in (("0", "16"), ("0", "8"),
                                             ("0", "1"), ("1", "0"),
                                             ("2", "0")) for nav in (0, 1)]
    prod += [f"_ZN12_GLOBAL__N_117synth_rows_kernelILi{m}EEEvPKiS2_S2_PiS3_i"
             for m in (1, 2)]
    prof = [f"_ZN12_GLOBAL__N_120synth_profile_kernelILi{f}ELi{mask}EEEvPKiS2"
            f"_S2_Piii" for f in (16, 8, 1) for mask in (1, 2, 4, 3)]
    return {lib: ("".join(_kernel_sass(n) for n in names),
                  "".join(_ptxas(n) for n in names))
            for lib, names in (("synth", prod), ("synth_profile", prof))}


def test_sass_classes():
    want = {"IADD3": "add", "IADD3.X": "add", "IMAD": "multiply",
            "IMAD.WIDE.U32": "multiply", "IMAD.HI.U32": "multiply",
            "IMUL": "multiply", "IMAD.MOV.U32": "imad_move",
            "IMAD.SHL.U32": "imad_move", "IMAD.IADD": "imad_move",
            "SHF.R.W.U32": "shift", "SHF.L.U64.HI": "shift",
            "LEA.HI.X": "shift", "LOP3.LUT": "bitwise",
            "ISETP.GE.AND": "compare_select", "SEL": "compare_select",
            "LDS": "shared_load", "LDS.64": "shared_load",
            "LDS.U.128": "shared_load", "STG.E": "global_store",
            "REDUX.OR": "warp", "VOTE.ANY": "warp", "SHFL.IDX": "warp",
            "BRA": "control", "BAR.SYNC.DEFER_BLOCKING": "control",
            "EXIT": "control", "MOV": "other", "UIADD3": "other",
            "S2R": "other", "LDG.E": "other", "STS": "other"}
    assert {op: op_budget.classify(op) for op in want} == want
    assert set(want.values()) == set(op_budget.CLASS_NAMES)


def test_channel_trip_and_its_split():
    """The longest loop is the channel loop (synth_cuda.channel_loops, the
    one finder of phase 2 and op_budget); the body is what repeats per
    sample (STEP + SAMPLE), the setup the rest of the trip: SETUP, the
    loop test and branch, less the first sample's missing phase step."""
    S = synth_cuda.SAMPLES_PER_TRIP
    loops = synth_cuda.sass_loops(_kernel_sass("k"))
    assert len(loops["k"]) == 2
    trip = synth_cuda.channel_loops(loops, key_of=lambda fn: fn,
                                    keys=["k"])["k"]
    assert trip == max(loops["k"], key=len)
    assert len(trip) == len(SETUP) + S * len(SAMPLE) + (S - 1) * len(
        STEP) + len(TAIL) + 1
    body, setup = op_budget.split_trip(trip)
    assert sum(body.values()) == len(STEP) + len(SAMPLE)
    assert sum(setup.values()) == len(SETUP) + len(TAIL) + 1 - len(STEP)
    assert len(trip) == S * sum(body.values()) + sum(setup.values())
    assert op_budget.by_class(body) == {
        "add": 5, "imad_move": 0, "multiply": 2, "shift": 2, "bitwise": 1,
        "compare_select": 0, "shared_load": 2, "global_store": 0, "warp": 0,
        "control": 0, "other": 0}
    assert op_budget.by_class(setup) == {
        "add": 1 - 5, "imad_move": 2, "multiply": 2, "shift": 1,
        "bitwise": 0, "compare_select": 1, "shared_load": 3,
        "global_store": 0, "warp": 0, "control": 1, "other": 0}


def _profile_json():
    """profile_kernel's JSON as a card run writes it, cut to what op_budget
    reads: vpu_peak's costs and each variant's time."""
    peak = {"peak_sass_per_s": 25e12, "peak_source_ops_per_s": 20e12,
            "gather_cost_alu_ops": 4.0, "imul_cost_alu_ops": 0.8,
            "f32_roundtrip_cost_alu_ops": 3.0, "card": "H100, 700.00 W"}
    rows = {name: {"best_s": 1e-3 * (i + 1), "chan_samples": 10**9}
            for i, name in enumerate(profile_kernel.VARIANTS)}
    return {"vpu_peak_ref": peak, "rows": rows,
            "overhead_separation": {"kernel_slope_ns_per_chan_sample": 0.9}}


def test_op_budget_on_handwritten_sass(tmp_path, capsys):
    """--cpu --sass-dir: every instantiation of both libraries counted,
    priced with the profile's vpu_peak costs and reconciled with its
    times."""
    d = tmp_path / "sass"
    d.mkdir()
    for lib, (sass_text, ptxas_text) in _library_texts().items():
        (d / f"{lib}.sass").write_text(sass_text)
        (d / f"{lib}.ptxas.txt").write_text(ptxas_text)
    prof = tmp_path / "profile.json"
    prof.write_text(json.dumps(_profile_json()))
    out = tmp_path / "budget.json"
    assert op_budget.main(["--cpu", "--sass-dir", str(d), "--profile",
                           str(prof), "--json", str(out),
                           "--dump-dir", str(tmp_path / "again")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    full = json.loads(out.read_text())
    assert full["metric"] == "kernel_static_op_budget"
    assert sorted(full["instantiations"]) == sorted(
        synth_cuda.all_instantiation_keys() + synth_cuda.all_profile_keys())
    S = synth_cuda.SAMPLES_PER_TRIP
    per = (len(SETUP) + S * len(SAMPLE) + (S - 1) * len(STEP) + len(TAIL)
           + 1) / S
    b = full["instantiations"]["synth_wire/16/no_gathers"]
    assert b["library"] == "synth_profile"
    assert b["sass_per_chan_sample"] == per
    assert b["body_per_sample"] == len(STEP) + len(SAMPLE)
    # Per opcode the two net: the loop counter's IADD3 against one of the
    # two the first sample skips.
    assert b["setup_own_per_trip"] == len(SETUP) + len(TAIL) + 1 - 1
    assert b["skipped_by_first_sample_per_trip"] == len(STEP) - 1
    assert b["setup_per_trip"] == len(SETUP) + len(TAIL) + 1 - len(STEP)
    assert b["ptxas"] == {"registers": 72, "smem_bytes": 17540,
                          "spill_stores": 0, "spill_loads": 0}
    cost = full["pricing_costs"]
    assert cost["sass_per_alu_source_op"] == 1.25
    assert cost["multiply_sass"] == 1.0 and cost["shared_load_sass"] == 5.0
    classes = b["classes_per_chan_sample"]
    equiv = per + (cost["shared_load_sass"] - 1) * classes["shared_load"]
    assert b["pricing"]["equiv_sass_per_chan_sample"] == pytest.approx(equiv)
    assert b["pricing"]["predicted_ns_per_chan_sample"] == pytest.approx(
        equiv / 25e12 * 1e9)
    rec = full["reconcile"]
    assert sorted(rec["variants"]) == sorted(profile_kernel.VARIANTS)
    assert rec["variants"]["full"]["measured_ns_per_chan_sample"] == \
        pytest.approx(1e-3)
    assert line["default_sass_per_chan_sample"] == per
    assert line["full_predicted_over_slope"] == pytest.approx(
        equiv / 25e12 * 1e9 / 0.9)
    assert line["card"] == "H100, 700.00 W"
    assert (tmp_path / "again" / "synth_profile.sass").read_text() == \
        (d / "synth_profile.sass").read_text()


def test_op_budget_refuses_a_library_with_missing_kernels():
    sass_text, ptxas_text = _library_texts()["synth_profile"]
    cut = sass_text.split("        Function : ")
    with pytest.raises(AssertionError, match="SASS holds"):
        op_budget.budget("        Function : ".join(cut[:-1]), ptxas_text,
                         "synth_profile")
    with pytest.raises(AssertionError, match="-Xptxas -v holds"):
        op_budget.budget(sass_text, "", "synth_profile")


# ---------------------------------------------------------------------------
# Who reaches the ablated launcher.
# ---------------------------------------------------------------------------

ABLATED_NAMES = {"launch_ablated", "load_profile", "PROFILE_SOURCE",
                 "synth_wire_ablated", "synth_profile_launch"}


def test_only_the_attribution_tools_reach_the_ablated_kernels():
    """The names that reach the ablated kernels appear, outside
    ops/synth_cuda.py (which defines them), only in
    tools/profile_kernel.py, tools/op_budget.py and chip_smoke.py."""
    allowed = {PKG / "ops" / "synth_cuda.py",
               PKG / "tools" / "profile_kernel.py",
               PKG / "tools" / "op_budget.py", ROOT / "chip_smoke.py"}
    reaching = set()
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            name = (node.attr if isinstance(node, ast.Attribute)
                    else node.id if isinstance(node, ast.Name)
                    else node.name if isinstance(node, ast.alias)
                    else None)
            if name in ABLATED_NAMES or (
                    isinstance(node, ast.Constant)
                    and node.value in ABLATED_NAMES):
                reaching.add(path)
    assert reaching - allowed == set()
    assert {PKG / "tools" / "profile_kernel.py",
            PKG / "tools" / "op_budget.py",
            ROOT / "chip_smoke.py"} <= reaching
