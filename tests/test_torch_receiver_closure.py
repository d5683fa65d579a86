"""End-to-end closures of the port alone, on the CPU: synthesize with the
port's runner, then acquire, track, decode, fix and solve a baseline with
the port's receiver.

- 7.6 s: every acquired channel decodes parity-valid subframes whose bits
  appear verbatim in the stream the scenario transmitted.
- 26 s: the position fix lies within 10 m of the simulated location.
- Two 26 s captures about 32 m apart: the double-difference baseline fixes
  to within 5 mm.

The same closures as tests/test_receiver.py and tests/test_receiver_rtk.py
with the same thresholds; chip_smoke.py runs the last two on the card.
"""

import numpy as np
import pytest

from gps_sdr_sim_tpu_torch.receiver import (
    acquire,
    bit_sync,
    decode_bits,
    frame_sync,
    track,
)
from gps_sdr_sim_tpu_torch.receiver.pvt import observables, solve
from gps_sdr_sim_tpu_torch.testing import (
    RX_FS,
    RX_ROVER,
    TOKYO,
    rtk_baseline,
    rx_capture,
    rx_scenario,
)

pytestmark = [pytest.mark.receiver, pytest.mark.slow]


def _track(scn):
    x = rx_capture(scn, "torch", "cpu")
    return track(x, RX_FS, acquire(x, RX_FS, dopp_step=50.0, device="cpu"),
                 device="cpu")


def test_nav_message_decodes_bit_exact():
    scn = rx_scenario(7.6)
    tracked = _track(scn)
    seg = scn.segments[0]
    assert set(int(p) for p in tracked.prns) == \
        set(int(p) for p in seg.prn[seg.active])
    tx_by_prn = {int(p): "".join(map(str, (b + 1) // 2))
                 for p, b in zip(seg.prn, seg.bits) if p > 0}
    for c, prn in enumerate(tracked.prns):
        p = tracked.prompt[:, c]
        sbfs = frame_sync(decode_bits(p, bit_sync(p)))
        assert sbfs, f"PRN {prn}: no parity-valid subframe decoded"
        for sbf in sbfs:
            # Either polarity: the Costas loop's 180-degree ambiguity.
            got = "".join(map(str, sbf.bits))
            inv = "".join(map(str, 1 - sbf.bits))
            tx = tx_by_prn[int(prn)]
            assert got in tx or inv in tx, f"PRN {prn}: bits not transmitted"
            assert sbf.tow_sec % 6.0 == 0.0


@pytest.fixture(scope="module")
def base_track():
    return _track(rx_scenario(26.0))


def test_pvt_fix_within_10_m(base_track):
    obs, ionoutc = observables(base_track)
    sol = solve(obs, ionoutc)
    err = np.linalg.norm(sol.xyz - TOKYO)
    assert sol.n_sats >= 4
    assert err < 10.0, f"position error {err:.2f} m with {sol.n_sats} sats"
    assert np.max(np.abs(sol.residuals)) < 5.0


def test_rtk_baseline_fixes_to_millimeters(base_track):
    sol = rtk_baseline(base_track, _track(rx_scenario(26.0, RX_ROVER)))
    assert sol.fixed and sol.ratio > 3.0, (sol.ratio, sol.amb_frac)
    err = np.linalg.norm(sol.baseline - (RX_ROVER - TOKYO))
    assert err < 0.005, f"fixed baseline error {err * 1e3:.2f} mm"
    assert sol.phase_rms < 0.005
