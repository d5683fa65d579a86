"""The port's synthesis (gps_sdr_sim_tpu_torch.ops.synth) against the JAX
package: the XLA path, the Pallas kernel run in interpret mode, and
seeded random wires. All arithmetic is integer, so every comparison is
exact (tolerance zero). On the CPU `synth_wire` runs its plain version;
the CUDA kernel is compared with it by the gpu-marked test at the end and
by chip_smoke.py on the card."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu.ops import synth_pallas
from gps_sdr_sim_tpu.ops.plan import pad_epochs, plan_epochs
from gps_sdr_sim_tpu.ops.quantize import pack
from gps_sdr_sim_tpu.runner import run_simulation as jax_run_simulation
from gps_sdr_sim_tpu_torch.ops import synth
from gps_sdr_sim_tpu_torch.ops.quantize import (
    checksum_bytes,
    checksum_packed,
    words_to_bytes,
    wrap_int32,
)
from gps_sdr_sim_tpu_torch.runner import run_simulation
from gps_sdr_sim_tpu_torch.testing import NAV, SCENARIOS, TOKYO, random_wire

CPU = torch.device("cpu")
RATES = [1.0e6, 1310720.0, 1331200.0, 2.6e6]


def _scenario(samp_freq, fmt, duration=0.2, **kw):
    kw.setdefault("static_xyz", TOKYO)
    return build_scenario(ScenarioConfig(
        nav_file=str(NAV), duration=duration, samp_freq=samp_freq,
        data_format=fmt, **kw))


def _port_bytes(scn, batch_epochs=2):
    buf = io.BytesIO()
    run_simulation(scn, buf, batch_epochs=batch_epochs, log=lambda s: None,
                   impl="torch", device=CPU)
    return buf.getvalue()


def _jax_bytes(scn, impl, batch_epochs=2):
    buf = io.BytesIO()
    jax_run_simulation(scn, buf, batch_epochs=batch_epochs,
                       log=lambda s: None, impl=impl)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", [16, 8, 1])
@pytest.mark.parametrize("samp_freq", RATES)
def test_plain_matches_xla(samp_freq, fmt):
    """Rates give distinct sub-block geometries (49, 64, 65, 127 per
    epoch) and 1.0 Msps a code step above one chip per sample."""
    scn = _scenario(samp_freq, fmt)
    assert _port_bytes(scn) == _jax_bytes(scn, "xla")


@pytest.mark.parametrize("name", ["highalt16", "staticfix16"])
def test_plain_matches_xla_golden_configs(name):
    """highalt16: gains above the TPU kernel's premultiplied-table bound;
    staticfix16: the fixed-point carrier NCO."""
    kw = {k: v for k, v in SCENARIOS[name].items() if k != "data_format"}
    scn = _scenario(1.0e6, 16, **kw)
    if name == "highalt16":
        assert int(scn.segments[0].gain.max()) > synth_pallas.PREMULT_MAX_GAIN
    assert _port_bytes(scn) == _jax_bytes(scn, "xla")


@pytest.mark.parametrize("fmt", [16, 1])
def test_plain_matches_pallas_interpret(fmt):
    scn = _scenario(1.0e6, fmt)
    n = scn.iq_buff_size
    eb = pad_epochs(plan_epochs(scn.segments[0], 0, 2, scn.delt), 2)
    want = np.asarray(synth_pallas.synth_staged_packed(
        synth_pallas.stage_epochs(eb), n, fmt))
    got = synth.synth_staged_packed(synth.stage_epochs(eb, CPU), n, fmt)
    np.testing.assert_array_equal(words_to_bytes(got.numpy(), n, fmt),
                                  words_to_bytes(want, n, fmt))


# ---------------------------------------------------------------------------
# Seeded random wires.
# ---------------------------------------------------------------------------


def _pallas_words(wire, ca, n_chan, n_out, fmt):
    code_s = wire[..., 2:4].copy().view(np.int64)[..., 0]
    staged = (jnp.asarray(wire), jnp.asarray(ca), n_chan,
              synth_pallas.premult_ok(wire[:, :n_chan, 11]),
              bool(np.any(code_s >> 56)))
    return np.asarray(synth_pallas.synth_staged_packed(staged, n_out, fmt))


# The interpreter's compile time grows with the channel count (~1 s per
# channel), so only one case runs all 16.
@pytest.mark.parametrize("seed,fmt,max_gain,n_chan", [
    (0, 16, 400, 16), (1, 8, 131, 5), (2, 1, 131, 3)])
def test_random_wires_match_pallas_interpret(seed, fmt, max_gain, n_chan):
    """max_gain 400 takes the Pallas kernel's in-mix gain variant."""
    n_out = 4096
    wire, ca, n_chan = random_wire(seed, n_chan=n_chan, max_gain=max_gain)
    want = _pallas_words(wire, ca, n_chan, n_out, fmt)
    got = synth.synth_wire(torch.from_numpy(wire), torch.from_numpy(ca),
                           n_chan, n_out, fmt)
    assert got.shape == (2, synth.words_per_epoch(n_out, fmt))
    np.testing.assert_array_equal(words_to_bytes(got.numpy(), n_out, fmt),
                                  words_to_bytes(want, n_out, fmt))


# ---------------------------------------------------------------------------
# The traps of the arithmetic, one fence each.
# ---------------------------------------------------------------------------


def test_floor_and_shift_rules_match_jax():
    """M and the nav index are floor divisions; a shift outside [0, 32)
    sign-fills, as jax.numpy's >> does (the rule the kernel spells out)."""
    a = np.arange(-3000, 3000, dtype=np.int32)
    np.testing.assert_array_equal(
        synth.floor_div(torch.from_numpy(a).long(), 1023).numpy(),
        np.asarray(jnp.floor_divide(jnp.asarray(a), 1023)))
    assert int(synth.floor_div(torch.tensor(-1), 20)) == -1
    x = np.array([0, 1, 77, 255, 2**31 - 1, -1, -77, -(2**31)], np.int32)
    s = np.arange(-40, 41, dtype=np.int32)
    xx, ss = np.meshgrid(x, s)
    want = np.asarray(jnp.asarray(xx) >> jnp.asarray(ss))
    got = synth.shr_signfill(torch.from_numpy(xx).long(),
                             torch.from_numpy(ss).long()).numpy()
    np.testing.assert_array_equal(got, want)


def test_rebase_is_exact_where_naive_int64_overflows():
    """At 1 Msps the code step is ~1.02 * 2^56, so f + k0 * s reaches ~2^73
    within an epoch; the 16/40 split must equal Python's exact integers."""
    s = int(round(1.023e6 / 1.0e6 * 2**56)) + 12345
    f = (1 << 56) - 3
    k0 = np.arange(0, 100_000, 2048, dtype=np.int64)
    naive = np.int64(f) + k0 * np.int64(s)  # wraps silently
    exact = [f + int(k) * s for k in k0]
    assert any(int(v) != e for v, e in zip(naive, exact))
    base, carry = synth.rebase(torch.tensor(f), torch.tensor(s),
                               torch.from_numpy(k0))
    for b, c, e in zip(base.tolist(), carry.tolist(), exact):
        assert b == (e >> 16) & ((1 << 40) - 1) and c == e >> 56


def _one_channel_wire(t0=0, m0=0, b0=0, navbits=0, gain=100, code_f=0,
                      code_s=1 << 55, carr_s=0):
    wire = np.zeros((1, 1, 12), np.int32)
    for lane, v in ((0, code_f), (2, code_s), (6, carr_s)):
        wire[0, 0, lane:lane + 2] = np.array([v], np.int64).view(np.int32)
    wire[0, 0, 8] = t0
    wire[0, 0, 9] = m0 | (b0 << 16)
    wire[0, 0, 10] = navbits
    wire[0, 0, 11] = gain
    return wire


def _iq(wire, ca, n_out=2048):
    words = synth.synth_wire(torch.from_numpy(wire), torch.from_numpy(ca), 1,
                             n_out, 16)
    return words.numpy().view(np.int16).reshape(-1, 2)


def test_t_minus_one_and_mg_minus_one():
    """T = -1 is chip 1022 of code period M = -1 (floor, not truncation);
    with m0 a multiple of 20, mg = -1 too, and navbits >> -1 sign-fills to
    nav bit 0 where a truncating j = 0 would read bit 0 (= 1 here)."""
    from gps_sdr_sim_tpu.ops.tables import COS_TABLE512, SIN_TABLE512

    ca = np.zeros((1, 32), np.int32)
    ca[0, 31] = 1 << (1022 - 31 * 32)  # only chip 1022 is a one
    # 0.5 chip/sample from t0 = -1: samples 0, 1 have T = -1, sample 2 T = 0.
    iq = _iq(_one_channel_wire(t0=-1, m0=40, b0=2, navbits=1), ca)
    g = 100
    pos = ((g * int(COS_TABLE512[0]) + 64) >> 7,
           (g * int(SIN_TABLE512[0]) + 64) >> 7)  # carrier index 0 throughout
    neg = ((-g * int(COS_TABLE512[0]) + 64) >> 7,
           (-g * int(SIN_TABLE512[0]) + 64) >> 7)
    # T = -1: C/A chip 1022 (bit 1) XOR nav bit 0 (sign fill) -> negative
    assert tuple(iq[0]) == tuple(iq[1]) == neg
    # T = 0: C/A chip 0 (bit 0) XOR nav bit 0 of the window (1) -> negative
    assert tuple(iq[2]) == neg
    # With the window's bit 0 clear, T = 0 turns positive; T = -1 is
    # unchanged because it never reads the window.
    iq0 = _iq(_one_channel_wire(t0=-1, m0=40, b0=2, navbits=0), ca)
    assert tuple(iq0[0]) == neg and tuple(iq0[2]) == pos


def test_m0_fold():
    """The nav index is floor((m0 - 20*b0 + M) / 20): the window starts at
    bit b0. Shifting m0 by 20 together with b0 changes nothing; shifting m0
    alone moves the window by one bit and must change the output."""
    ca = np.full((1, 32), -1, np.int32)
    nav = 0b10101010
    base = _iq(_one_channel_wire(m0=5, b0=0, navbits=nav), ca, 41 * 2048)
    same = _iq(_one_channel_wire(m0=25, b0=1, navbits=nav), ca, 41 * 2048)
    unfolded = _iq(_one_channel_wire(m0=25, b0=0, navbits=nav), ca,
                   41 * 2048)
    np.testing.assert_array_equal(base, same)
    assert not np.array_equal(base, unfolded)


def test_int16_wrap_precedes_sc08_and_sc01():
    """With large gains the quantized sample leaves int16; SC08 and SC01
    read the int16-WRAPPED sample (the reference's short buffer). Checked
    against the JAX package's own packers applied to the SC16 stream."""
    wire, ca, _ = random_wire(7, n_epochs=1, n_chan=16, max_gain=0)
    wire[..., 11] = 30000
    i16, _q16 = synth._quantized_iq(torch.from_numpy(wire),
                                    torch.from_numpy(ca), 16, 2)
    assert int(i16.abs().max()) > 32767  # the wrap is exercised
    n = 4096
    w16, w8, w1 = (synth.synth_wire(torch.from_numpy(wire),
                                    torch.from_numpy(ca), 16, n, f).numpy()
                   for f in (16, 8, 1))
    iq = jnp.asarray(w16.view(np.int16).reshape(1, -1, 2)[:, :n])
    np.testing.assert_array_equal(words_to_bytes(w8, n, 8).ravel(),
                                  np.asarray(pack(iq, 8)).view(np.uint8)
                                  .ravel())
    np.testing.assert_array_equal(words_to_bytes(w1, n, 1).ravel(),
                                  np.asarray(pack(iq, 1)).ravel())


# ---------------------------------------------------------------------------
# Checksums (the bench golden's semantics).
# ---------------------------------------------------------------------------


def test_checksum_matches_jax_and_int32_wrap():
    from gps_sdr_sim_tpu.ops.quantize import checksum_packed as jax_checksum

    scn = _scenario(1.0e6, 16, duration=0.3)
    n = scn.iq_buff_size
    eb = pad_epochs(plan_epochs(scn.segments[0], 0, 2, scn.delt), 3)
    staged = synth.stage_epochs(eb, CPU)
    for fmt in (16, 8, 1):
        words = synth.synth_staged_packed(staged, n, fmt)
        s, nz = checksum_packed(words, 2, n, fmt)
        js, jnz = jax_checksum(jnp.asarray(words.numpy()), 2, n, fmt)
        assert (int(s), int(nz)) == (int(js), int(jnz))
        data = bytearray(words_to_bytes(words.numpy()[:2], n, fmt))
        assert checksum_bytes(data, fmt) == (int(s), int(nz))
    # bench.py's int32 accumulation (x64 off) is the sum mod 2^32.
    assert not jax.config.jax_enable_x64
    big = np.full(1000, 2**30 + 12345, np.int32)
    assert int(jnp.sum(jnp.asarray(big), dtype=jnp.int64)) == \
        wrap_int32(int(big.astype(np.int64).sum()))
