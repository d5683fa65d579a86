"""ctypes bindings for the native playerfmt library (tools/playerfmt.cpp).

Gives the Python framework direct access to the C++ sample-format
conversions used by the playback tool chain (1-bit LUT expansion, 12-bit
DAC rescaling, 16->8 narrowing) without spawning a subprocess. Build the
library with `make -C tools` first; `available()` reports whether it (or a
freshly built copy) can be loaded.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import numpy as np

_LIB_PATH = (pathlib.Path(__file__).resolve().parents[2] / "tools"
             / "libplayerfmt.so")
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.pf_expand_1bit.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int16,
            ctypes.POINTER(ctypes.c_int16)]
        lib.pf_shift16.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16)]
        lib.pf_widen8.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16)]
        lib.pf_narrow16to8.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int8)]
        _lib = lib
    return _lib


def available() -> bool:
    return _LIB_PATH.exists()


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def expand_1bit(packed: np.ndarray, amplitude: int = 2047) -> np.ndarray:
    """Packed SC01 bytes -> int16 interleaved I/Q at +-amplitude."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.empty(packed.size * 8, dtype=np.int16)
    _load().pf_expand_1bit(packed.tobytes(), packed.size,
                           amplitude, _ptr(out, ctypes.c_int16))
    return out


def shift16(values: np.ndarray, shift_right: int) -> np.ndarray:
    values = np.ascontiguousarray(values, dtype=np.int16)
    out = np.empty_like(values)
    _load().pf_shift16(_ptr(values, ctypes.c_int16), values.size,
                       shift_right, _ptr(out, ctypes.c_int16))
    return out


def widen8(values: np.ndarray, shift_left: int) -> np.ndarray:
    values = np.ascontiguousarray(values, dtype=np.int8)
    out = np.empty(values.size, dtype=np.int16)
    _load().pf_widen8(_ptr(values, ctypes.c_int8), values.size,
                      shift_left, _ptr(out, ctypes.c_int16))
    return out


def narrow16to8(values: np.ndarray, shift_right: int = 4) -> np.ndarray:
    values = np.ascontiguousarray(values, dtype=np.int16)
    out = np.empty(values.size, dtype=np.int8)
    _load().pf_narrow16to8(_ptr(values, ctypes.c_int16), values.size,
                           shift_right, _ptr(out, ctypes.c_int8))
    return out


# ---- SDR backend option validation (tools/sdr_backends.cpp) ----
# The clamping rules of the reference players, exported unconditionally
# (no vendor SDK needed) so they are testable without hardware.

def _load_sdr() -> ctypes.CDLL:
    lib = _load()
    if not hasattr(lib.sdr_lime_clamp_gain, "_typed"):
        lib.sdr_lime_clamp_gain.restype = ctypes.c_double
        lib.sdr_lime_clamp_gain.argtypes = [ctypes.c_double]
        lib.sdr_lime_clamp_dynamic.restype = ctypes.c_long
        lib.sdr_lime_clamp_dynamic.argtypes = [ctypes.c_long]
        lib.sdr_lime_clamp_channel.restype = ctypes.c_int
        lib.sdr_lime_clamp_channel.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.sdr_pluto_clamp_atten.restype = ctypes.c_double
        lib.sdr_pluto_clamp_atten.argtypes = [ctypes.c_double]
        lib.sdr_pluto_clamp_bw.restype = ctypes.c_double
        lib.sdr_pluto_clamp_bw.argtypes = [ctypes.c_double]
        lib.sdr_hackrf_filter_bw.restype = ctypes.c_uint32
        lib.sdr_hackrf_filter_bw.argtypes = [ctypes.c_uint32]
        lib.sdr_lime_clamp_gain._typed = True
    return lib


def lime_clamp_gain(gain: float) -> float:
    return _load_sdr().sdr_lime_clamp_gain(gain)


def lime_clamp_dynamic(dynamic: int) -> int:
    return _load_sdr().sdr_lime_clamp_dynamic(dynamic)


def lime_clamp_channel(channel: int, channel_count: int) -> int:
    return _load_sdr().sdr_lime_clamp_channel(channel, channel_count)


def pluto_clamp_atten(gain_db: float) -> float:
    return _load_sdr().sdr_pluto_clamp_atten(gain_db)


def pluto_clamp_bw(bw_hz: float) -> float:
    return _load_sdr().sdr_pluto_clamp_bw(bw_hz)


def hackrf_filter_bw(sample_rate_hz: int) -> int:
    return _load_sdr().sdr_hackrf_filter_bw(sample_rate_hz)


# ---- ByteRing (tools/bytering.cpp) ----
# The bounded blocking ring that inverts the push pipeline into HackRF's
# async-pull tx_callback (reference player/hackplayer.c:53-72). Compiled
# without any vendor SDK so the shutdown/backpressure logic is testable.

def _load_ring() -> ctypes.CDLL:
    lib = _load()
    if not hasattr(lib.pf_ring_new, "_typed"):
        lib.pf_ring_new.restype = ctypes.c_void_p
        lib.pf_ring_new.argtypes = [ctypes.c_size_t]
        lib.pf_ring_push.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int8), ctypes.c_size_t]
        lib.pf_ring_drain.restype = ctypes.c_size_t
        lib.pf_ring_drain.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int8), ctypes.c_size_t]
        lib.pf_ring_close.argtypes = [ctypes.c_void_p]
        lib.pf_ring_fill.restype = ctypes.c_size_t
        lib.pf_ring_fill.argtypes = [ctypes.c_void_p]
        lib.pf_ring_wait_drained.restype = ctypes.c_int
        lib.pf_ring_wait_drained.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pf_ring_free.argtypes = [ctypes.c_void_p]
        lib.pf_ring_new._typed = True
    return lib


class ByteRing:
    """Python handle on the native blocking byte ring (for tests)."""

    def __init__(self, capacity: int):
        self._lib = _load_ring()
        self._h = self._lib.pf_ring_new(capacity)

    def push(self, data: np.ndarray) -> None:
        data = np.ascontiguousarray(data, dtype=np.int8)
        self._lib.pf_ring_push(self._h, _ptr(data, ctypes.c_int8), data.size)

    def drain(self, want: int) -> np.ndarray:
        out = np.empty(want, dtype=np.int8)
        got = self._lib.pf_ring_drain(self._h, _ptr(out, ctypes.c_int8), want)
        return out[:got]

    def close(self) -> None:
        self._lib.pf_ring_close(self._h)

    def fill(self) -> int:
        return self._lib.pf_ring_fill(self._h)

    def wait_drained(self, timeout_ms: int) -> bool:
        return bool(self._lib.pf_ring_wait_drained(self._h, timeout_ms))

    def free(self) -> None:
        if self._h:
            self._lib.pf_ring_free(self._h)
            self._h = None
