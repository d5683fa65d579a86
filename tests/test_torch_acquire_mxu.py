"""The port's int8 circulant acquisition
(gps_sdr_sim_tpu_torch.receiver.acquire_mxu) against the JAX package's, on
the CPU.

- search_mxu equals gps_sdr_sim_tpu.receiver.acquire_mxu._acq_mxu_fn on the
  same blocks (32 PRNs x 201 Doppler bins x 4 blocks of 1 ms): the flat
  argmax equal, peak and mean within SEARCH_RTOL (the float32 sums run in
  another order).
- acquire_mxu() gives the JAX acquire_mxu()'s AcqResults, and the port's
  FFT acquire()'s detections (JAX's own rule: same PRNs and code phases,
  Doppler within 20 Hz).
- The zero-padded int8 product (torch._int_mm's shape rule on the card)
  equals an int64 product element by element where padding is needed: S =
  1023 (1.023 Msps) and 8 rows (one Doppler bin).
- acquire_mxu keeps JAX's signature and defaults, plus device="cuda".

The capture is the static Tokyo scenario, 2 s at 2.048 Msps, synthesized
by the JAX package (impl="xla"), as in tests/test_torch_receiver.py.
"""

import importlib
import inspect
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_sim_tpu.models import scenario as jax_scenario
from gps_sdr_sim_tpu.receiver.frontend import load_iq as jax_load_iq
from gps_sdr_sim_tpu.runner import run_simulation as jax_run_simulation
from gps_sdr_sim_tpu_torch import receiver
from gps_sdr_sim_tpu_torch.receiver.acquire import (
    AcqResult,
    sampled_codes,
    search_prep,
)
from gps_sdr_sim_tpu_torch.testing import (
    NAV,
    RX_FS,
    TOKYO,
    check_acquisition,
    check_search,
)

# The package binds acquire_mxu to the function; these are the modules.
mxu, jax_mxu = (importlib.import_module(f"{pkg}.receiver.acquire_mxu")
                for pkg in ("gps_sdr_sim_tpu_torch", "gps_sdr_sim_tpu"))
FS = RX_FS


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The int8 products on one torch thread, as the other receiver tests
    run their loops."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def x():
    scn = jax_scenario.build_scenario(jax_scenario.ScenarioConfig(
        nav_file=str(NAV), static_xyz=TOKYO, duration=2.0, samp_freq=FS,
        data_format=16))
    buf = io.BytesIO()
    jax_run_simulation(scn, buf, batch_epochs=16, impl="xla",
                       log=lambda s: None)
    return jax_load_iq(buf.getvalue(), 16)


@pytest.fixture(scope="module")
def ours(x):
    return receiver.acquire_mxu(x, FS, dopp_step=50.0, device="cpu")


def test_search_mxu_matches_jax_acq_mxu_fn(x):
    prns, s, codes, dopp, xb = search_prep(x, FS, None, 5000.0, 50.0, 4)
    inputs = mxu.search_inputs(xb, codes, dopp, "cpu")
    want = jax_mxu._acq_mxu_fn(s, len(dopp), 4, len(prns))(
        *(jnp.asarray(a.numpy()) for a in inputs), jnp.float32(FS))
    got = mxu.search_mxu(*inputs, FS)
    assert len(prns) == 32 and len(dopp) == 201 and s == 2048
    assert [a.dtype for a in got] == [torch.float32, torch.int64,
                                      torch.float32]
    check_search([a.numpy() for a in got], [np.asarray(a) for a in want])


def test_acquire_mxu_matches_jax(x, ours):
    want = jax_mxu.acquire_mxu(x, FS, dopp_step=50.0)
    check_acquisition(ours, [AcqResult(**vars(a)) for a in want])


def test_acquire_mxu_matches_fft_acquire(x, ours):
    fft = receiver.acquire(x, FS, dopp_step=50.0, device="cpu")
    assert [a.prn for a in ours] == [a.prn for a in fft]
    for g, f in zip(ours, fft):
        assert g.detected == f.detected, (g, f)
        if g.detected:
            assert g.code_phase == f.code_phase, (g, f)
            assert abs(g.doppler - f.doppler) < 20.0, (g, f)
    assert sum(a.detected for a in ours) == 13


@pytest.mark.parametrize("fs, dopp_max", [(1.023e6, 500.0), (FS, 0.0),
                                          (1.023e6, 0.0)])
def test_padded_product_is_exact(fs, dopp_max):
    """S = 1023 pads the widths to 1024; one Doppler bin (8 rows) pads the
    rows to 17. The int32 product, sliced back, equals the int64 one."""
    s = int(round(fs * 1e-3))
    n_rows = len(np.arange(-dopp_max, dopp_max + 125.0, 250.0)) * 4 * 2
    rows, n = mxu.padded_shape(n_rows, s)
    assert rows > 16 and n % 8 == 0 and (rows, n) != (n_rows, s)
    rng = np.random.default_rng(s + n_rows)
    a8 = rng.integers(-127, 128, (n_rows, s), dtype=np.int8)
    code = sampled_codes(fs)[6].astype(np.int8)
    idx = mxu.circulant_index(s, "cpu")
    circ = mxu.circulant(torch.from_numpy(code), idx)
    assert circ.shape == (n, n)
    assert not circ[s:].any() and not circ[:, s:].any()
    k = np.arange(s)
    want_circ = code[(k[None, :] - k[:, None]) % s]
    np.testing.assert_array_equal(circ[:s, :s].numpy(), want_circ)
    got = mxu.int_mm_padded(torch.from_numpy(a8), circ)
    assert got.dtype == torch.int32 and got.shape == (n_rows, s)
    np.testing.assert_array_equal(
        got.numpy().astype(np.int64),
        a8.astype(np.int64) @ want_circ.T.astype(np.int64))


def test_padded_search_matches_jax(x):
    """The whole search where both paddings apply: 1.023 Msps blocks (the
    first 4 ms of the capture, read as if sampled at 1.023 Msps) and one
    Doppler bin."""
    fs = 1.023e6
    prns, s, codes, dopp, xb = search_prep(x, fs, None, 0.0, 250.0, 4)
    inputs = mxu.search_inputs(xb, codes, dopp, "cpu")
    want = jax_mxu._acq_mxu_fn(s, len(dopp), 4, len(prns))(
        *(jnp.asarray(a.numpy()) for a in inputs), jnp.float32(fs))
    got = mxu.search_mxu(*inputs, fs)
    assert s == 1023 and len(dopp) == 1
    check_search([a.numpy() for a in got], [np.asarray(a) for a in want])


def test_signature_is_jaxs_plus_device():
    ours = inspect.signature(receiver.acquire_mxu).parameters
    ref = inspect.signature(jax_mxu.acquire_mxu).parameters
    assert list(ours) == list(ref) + ["device"]
    assert all(ours[k].default == ref[k].default for k in ref)
    assert ours["device"].default == "cuda"


def test_acquire_mxu_runs_on_the_card_unless_given_cpu(x, monkeypatch):
    """The inputs go to the CUDA device by default, to the CPU when named;
    nothing picks the device from what is available."""
    seen = []

    def spy(xb, codes, dopp, device):
        seen.append(torch.device(device).type)
        raise RuntimeError("stop")

    monkeypatch.setattr(mxu, "search_inputs", spy)
    for kw in ({}, {"device": "cpu"}):
        with pytest.raises(RuntimeError, match="stop"):
            receiver.acquire_mxu(x, FS, **kw)
    assert seen == ["cuda", "cpu"]


def test_circulant_refuses_a_mismatched_shape():
    a8 = torch.zeros((24, 1023), dtype=torch.int8)
    with pytest.raises(ValueError, match="circulant"):
        mxu.int_mm_padded(a8, torch.zeros((1023, 1023), dtype=torch.int8))
