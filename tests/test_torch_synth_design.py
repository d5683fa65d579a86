"""The synthesis kernel's schedule (csrc/synth.cu, modelled in plain torch by
ops.synth.schedule_sums and sign_words) against the JAX package.

The kernel steps each thread's phases by a stride instead of recomputing
them, reads the sign (C/A bit xor nav bit) from per-sub-block sign words
built in its prologue, and folds the sign into its trig-table index. The
model does the same in the same order, so holding it to the port's plain
channel sums (`_channel_sums`) and to the Pallas kernel run by the
interpreter holds the schedule to the reference: on seeded random wires
whose t0 = -1 rows reach T = -1 and mg = -1, at 1.03 chips per sample and
at the domain's edge, on a 1.0 Msps real plan and on the canonical
2.6 Msps plan, for the window walk and the mask table (M = -1 reading lane
127). All arithmetic is integer: every comparison is exact. The CUDA
kernel itself is held to the plain version on the card (chip_smoke.py,
tests/test_torch_gpu.py)."""

import re

import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu_torch.constants import SUBBLOCK
from gps_sdr_sim_tpu_torch.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu_torch.ops import synth, synth_cuda
from gps_sdr_sim_tpu_torch.ops.plan import pack_epoch_wire, plan_batch, plan_epochs
from gps_sdr_sim_tpu_torch.testing import DATA, NAV, TOKYO, random_wire

from test_torch_hostlayer import _pallas_iq
from test_torch_navgather import _jax_gather

CPU = torch.device("cpu")
MASK40 = (1 << 40) - 1
N_CHAN = 2  # channels summed wherever the interpreter runs


def _wrap32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _sums_equal(wire, ca, n_chan, sub_blocks, nav_gather):
    """schedule_sums = the plain channel sums, exactly (int64, before the
    int32 wrap). Returns the schedule's sums."""
    w, c = torch.from_numpy(wire), torch.from_numpy(ca)
    got = synth.schedule_sums(w, c, n_chan, sub_blocks, nav_gather)
    want = synth._accumulate_iq(w, c, n_chan, sub_blocks, nav_gather)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    return got


def test_schedule_constants_mirror_the_kernel():
    """The model's schedule is the kernel's: the constants of csrc/synth.cu."""
    src = synth_cuda.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThreads") == synth.THREADS
    assert const("kSignWords") == synth.SIGN_WORDS
    assert const("kPeriods") == synth.PERIODS
    assert const("kSubblock") == SUBBLOCK
    assert SUBBLOCK // synth.THREADS == synth.SAMPLES_PER_THREAD \
        == synth_cuda.SAMPLES_PER_TRIP


@pytest.mark.parametrize("nav_gather", [False, True])
def test_schedule_matches_channel_sums_on_random_wires(nav_gather):
    """Eight seeded wires (0.38-1.03 chips per sample, gains up to 400, 40%
    of rows with t0 = -1 and m0 a multiple of 20: T = -1 and mg = -1 at the
    first samples of the epoch)."""
    seen = 0
    for seed in range(8):
        wire, ca, n_chan = random_wire(seed, n_epochs=2, max_gain=400)
        seen += int((wire[:, :n_chan, 8] == -1).sum())
        _sums_equal(wire, ca, n_chan, 3, nav_gather)
    assert seen > 0


@pytest.mark.parametrize("chips_per_sample", [1.03, 1.9999])
def test_schedule_at_steep_code_steps(chips_per_sample):
    """1.03 chips per sample (random_wire's steepest, above the CLI's
    1 Msps floor), and just inside the domain's edge of 2, where a
    sub-block's 2048 samples span the most sign words."""
    wire, ca, n_chan = random_wire(3, n_epochs=2, n_chan=5, max_gain=400)
    step = np.full(wire.shape[:2], int(chips_per_sample * 2**56), np.int64)
    wire[..., 2:4] = step.view(np.int32).reshape(*wire.shape[:2], 2)
    for nav_gather in (False, True):
        _sums_equal(wire, ca, n_chan, 3, nav_gather)
    f = synth._wire_fields(torch.from_numpy(wire), 3)
    _, n_words = synth.sign_words(f, torch.from_numpy(ca), n_chan)
    want = (int(chips_per_sample * (SUBBLOCK - 1)) >> 5) + 1
    assert want <= int(n_words.max()) <= min(want + 1, synth.SIGN_WORDS)


def test_mask_table_reads_lane_127_at_m_minus_one():
    """Where T = -1 (code period M = -1) the mask-table schedule reads lane
    127 and the walk the window's sign fill: the two schedules differ there
    exactly as the plain versions do (ROADMAP C2), and each equals its own
    plain version."""
    wire, ca, n_chan = random_wire(0, n_epochs=2, max_gain=400)
    walk = _sums_equal(wire, ca, n_chan, 3, False)
    table = _sums_equal(wire, ca, n_chan, 3, True)
    assert any(not torch.equal(a, b) for a, b in zip(walk, table))


def _real_wire(samp_freq, motion=None):
    """Epoch 1 of a real plan (Tokyo static, or circle.csv): wire, C/A words
    and samples per epoch."""
    kw = dict(motion_file=str(DATA / "circle.csv")) if motion else dict(
        static_xyz=TOKYO)
    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), duration=0.3, samp_freq=samp_freq, **kw))
    eb = plan_epochs(scn.segments[0], 1, 2, scn.delt)
    assert eb.n_chan > N_CHAN
    return pack_epoch_wire(eb), eb.ca_words, scn.iq_buff_size


@pytest.mark.parametrize("nav_gather", [False, True])
@pytest.mark.parametrize("samp_freq,motion", [(1.0e6, False),
                                              (2.6e6, True)])
def test_schedule_matches_pallas_interpreter_on_real_plans(samp_freq, motion,
                                                           nav_gather):
    """1.0 Msps (the CLI's floor: the steepest code step) and the canonical
    2.6 Msps circle.csv plan: the schedule's sums, wrapped to int32, are the
    Pallas kernel's raw sums (quantize=False; tpe > 0 for the mask table),
    on the first N_CHAN channels; on all active channels they are the plain
    sums."""
    wire, ca, n = _real_wire(samp_freq, motion)
    sb = -(-n // SUBBLOCK)
    i, q = (_wrap32(x).reshape(1, -1)[:, :n].numpy() for x in _sums_equal(
        wire, ca, N_CHAN, sb, nav_gather))
    if nav_gather:
        want = _jax_gather(wire, ca, N_CHAN, n, "raw")
    else:
        want = tuple(x[:, :n] for x in _pallas_iq(wire, ca, N_CHAN, n,
                                                  quantize=False))
    np.testing.assert_array_equal(i, want[0])
    np.testing.assert_array_equal(q, want[1])
    n_chan = int((wire[0, :, 11] != 0).sum())
    _sums_equal(wire, ca, n_chan, sb, nav_gather)


def _stride_walk(base, step, t, n_samples=synth.SAMPLES_PER_THREAD):
    """The kernel's recurrence for thread t, in Python integers: the
    fraction held in the top 40 bits of a 64-bit word, whose add's carry-out
    goes into the chip count (add.cc / addc), and the carrier held shifted
    by 24. Returns [(chips, table index)] per sample."""
    stride = synth.THREADS * step
    v = base + t * step
    chips, frac = v >> 40, (v << 24) % 2**64
    carr = (v << 24) % 2**64
    d_frac, d_whole = (stride << 24) % 2**64, stride >> 40
    out = []
    for k in range(n_samples):
        if k:
            s = frac + d_frac
            chips += d_whole + (s >> 64)
            frac = s % 2**64
            carr = (carr + d_frac) % 2**64
        out.append((chips, carr >> 55))
    return out


@pytest.mark.parametrize("step", [
    (int(round(1.023e6 / 1.0e6 * 2**56)) + 12345) >> 16,  # 1 Msps
    (synth.MAX_CODE_STEP >> 16) - 1,                      # the domain edge
    (1 << 48) - 1])                                       # the widest carrier
def test_stride_recurrence_is_exact(step):
    """Stepping by THREADS * step equals base + r * step for every sample
    r = t + THREADS * k of a sub-block, at the extremes of
    test_rebase_is_exact_where_naive_int64_overflows (base40 just below
    2^40, a code step of ~1.02 * 2^56) and of the kernel's domain. The
    sums stay below 2^64: nothing wraps."""
    for base in (0, MASK40, 0x123456789A):
        assert base + (SUBBLOCK - 1) * step < 2**64
        for t in (0, 1, 77, synth.THREADS - 1):
            for k, (chips, idx) in enumerate(_stride_walk(base, step, t)):
                v = base + (t + synth.THREADS * k) * step
                assert chips == v >> 40
                assert idx == (v >> 31) & 0x1FF


def test_sign_words_cover_the_cli_domain():
    """A sub-block spans fewer chips than the SIGN_WORDS * 32 bits of a
    channel's sign words for every code step below MAX_CODE_STEP at any
    fractional phase, and the words reach at most PERIODS code periods;
    the steepest real plan (1 Msps, the CLI's floor, the fastest motion
    file) is far inside."""
    step = (synth.MAX_CODE_STEP >> 16) - 1
    span = (MASK40 + (SUBBLOCK - 1) * step) >> 40
    assert (span >> 5) + 1 <= synth.SIGN_WORDS
    last = (1022 + 32 * (synth.SIGN_WORDS - 1)) // 1023  # from chip 1022
    assert last + 1 < synth.PERIODS
    for motion in ("circle.csv", "satellite.csv"):
        scn = build_scenario(ScenarioConfig(
            nav_file=str(NAV), motion_file=str(DATA / motion), duration=0.3,
            samp_freq=1.0e6))
        eb = plan_epochs(scn.segments[0], 0, 2, scn.delt)
        active = eb.gain != 0
        assert int(eb.code_s[active].max()) < 1.1 * 2**56
        synth.check_code_steps(eb.code_s, eb.gain)


def test_wrapper_refuses_a_wire_beyond_the_domain():
    """A wire or rows bound for a card with a channel whose code step is 2
    chips per sample or more is refused on the host, before any upload
    (so this runs without a card): by stage_epochs, upload_wire and the
    row path; the model raises as the kernel traps. A channel without gain
    is never read, and the CPU's plain version takes any step (200 ksps:
    5.1 chips per sample)."""
    card = torch.device("cuda")
    wire, ca, n_chan = random_wire(1, n_epochs=2, n_chan=4)
    step = np.full(wire.shape[:2], synth.MAX_CODE_STEP, np.int64)
    wire[..., 2:4] = step.view(np.int32).reshape(*wire.shape[:2], 2)
    wire[..., 11] = 0
    synth.check_code_steps(step, wire[..., 11])  # no gain: never read
    synth.upload_wire(wire, CPU)
    wire[0, 1, 11] = 7
    with pytest.raises(ValueError, match="outside the CUDA kernel's domain"):
        synth.upload_wire(wire, card)

    scn = build_scenario(ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO, duration=0.3, samp_freq=2.0e5))
    seg = scn.segments[0]
    eb = plan_epochs(seg, 0, 1, scn.delt)
    staged = synth.stage_epochs(eb, CPU)
    with pytest.raises(ValueError, match="5.1"):
        synth.stage_epochs(eb, card)
    db = plan_batch(seg, 0, 1, scn.iq_buff_size, scn.delt)
    with pytest.raises(ValueError, match="outside the CUDA kernel's domain"):
        synth.synth_batch(db, scn.iq_buff_size, card)
    with pytest.raises(ValueError, match="more than the kernel's"):
        synth.schedule_sums(staged.wire, staged.ca_words, staged.n_chan, 1)
    words = synth.synth_wire(staged.wire, staged.ca_words, staged.n_chan,
                             scn.iq_buff_size, 16)
    assert torch.equal(words, synth.synth_wire_ref(
        staged.wire, staged.ca_words, staged.n_chan, scn.iq_buff_size, 16))
