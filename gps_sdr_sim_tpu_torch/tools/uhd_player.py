"""Stream a gpssim.bin capture to a USRP via UHD (or to a file, for test).

Counterpart of tools/uhd_player.py, with the same flags and the same fc32
stream: it replaces the reference's GNU Radio flowgraph player
(gps-sdr-sim-uhd.py: file_source -> interleaved_short_to_complex ->
x(1/2^11) -> uhd.usrp_sink) with a plain UHD streaming loop, and reads all
three sample formats (16/8/1-bit) through the port's receiver front end
(gps_sdr_sim_tpu_torch/receiver/frontend.py load_iq, NumPy only). It needs
no card: nothing here touches torch.cuda.

Without UHD installed (no SDR hardware), --sink FILE writes the fc32
stream that would have been handed to the DAC. -t /dev/stdin reads a
capture piped from the CLI's -o -.

Usage:
  python -m gps_sdr_sim_tpu_torch.tools.uhd_player -t gpssim.bin
      [-s 2500000] [-b 16] [-f 1575420000] [-x gain] [-a uhd_args]
      [-c clock_source] [--no-repeat] [--sink FILE]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from gps_sdr_sim_tpu_torch.receiver.frontend import load_iq

# The reference scales int16 samples by 1/2^11 so a +/-2047 signal stays
# inside +/-1.0 at the DAC (gps-sdr-sim-uhd.py "scale of 1.0/2**11").
SCALE = 1.0 / 2048.0
CHUNK = 1 << 18  # IQ pairs per send


def iter_fc32(path: str, bits: int, repeat: bool):
    """Yield complex64 chunks scaled for the DAC, looping if repeat."""
    bytes_per_pair = {16: 4, 8: 2, 1: 0.25}[bits]
    while True:
        with open(path, "rb") as fp:
            while True:
                raw = fp.read(int(CHUNK * bytes_per_pair))
                if not raw:
                    break
                x = load_iq(raw, bits)
                if bits == 8:
                    x = x * 16.0  # 8->12-bit <<4, as limeplayer.c:336-342
                elif bits == 1:
                    x = x * 1000.0  # 1-bit amplitude per bladeplayer.c:26
                yield (x * SCALE).astype(np.complex64)
        if not repeat:
            return


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_sim_tpu_torch.tools.uhd_player")
    ap.add_argument("-t", "--filename", default="gpssim.bin")
    ap.add_argument("-s", "--sample-rate", type=float, default=2.5e6)
    ap.add_argument("-b", "--bits", type=int, default=16, choices=(1, 8, 16))
    ap.add_argument("-f", "--frequency", type=float, default=1575.42e6)
    ap.add_argument("-x", "--gain", type=float, default=0.0)
    ap.add_argument("-a", "--args", default="", help="UHD device args")
    ap.add_argument("-c", "--clock-source", default="internal")
    ap.add_argument("--no-repeat", action="store_true")
    ap.add_argument("--sink", default="",
                    help="write fc32 to this file instead of a USRP")
    ns = ap.parse_args(argv)

    chunks = iter_fc32(ns.filename, ns.bits, repeat=not ns.no_repeat)

    if ns.sink:
        with open(ns.sink, "wb") as out:
            for x in chunks:
                out.write(x.tobytes())
        return 0

    try:
        import uhd
    except ImportError:
        print("ERROR: UHD python module not available; use --sink FILE "
              "to exercise the format path without hardware.",
              file=sys.stderr)
        return 1

    usrp = uhd.usrp.MultiUSRP(ns.args)
    usrp.set_tx_rate(ns.sample_rate)
    usrp.set_tx_freq(ns.frequency)
    usrp.set_tx_gain(ns.gain)
    usrp.set_clock_source(ns.clock_source)

    st_args = uhd.usrp.StreamArgs("fc32", "sc16")
    tx = usrp.get_tx_stream(st_args)
    md = uhd.types.TXMetadata()
    md.start_of_burst = True
    for x in chunks:
        tx.send(x, md)
        md.start_of_burst = False
    md.end_of_burst = True
    tx.send(np.zeros(0, np.complex64), md)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
