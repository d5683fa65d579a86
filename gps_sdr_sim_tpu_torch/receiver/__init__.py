"""Software GPS L1 C/A receiver: the port's hardware-free validation path.

The port of gps_sdr_sim_tpu.receiver. Acquisition (acquire.py, an FFT
code-phase search in torch.fft; acquire_mxu.py, the same search as int8
circulant matrix products on the card's int8 tensor cores) and tracking
(track.py, DLL/PLL loops over [C, S] channel tensors) run on a torch
device, the CUDA card unless the caller names the CPU. The rest is the JAX
package's NumPy code with only its import paths changed: the front end
(frontend.py), nav-message bit and frame sync and parity-checked decode
(navdec.py, ephdec.py), the position fix (pvt.py), RINEX output and input
(rinex.py, rinexobs.py) and the double-difference baseline (ambiguity.py,
rtk.py).
"""

from gps_sdr_sim_tpu_torch.receiver.frontend import load_iq
from gps_sdr_sim_tpu_torch.receiver.acquire import acquire
from gps_sdr_sim_tpu_torch.receiver.acquire_mxu import acquire_mxu
from gps_sdr_sim_tpu_torch.receiver.track import track
from gps_sdr_sim_tpu_torch.receiver.navdec import (
    bit_sync,
    decode_bits,
    frame_sync,
    parity_ok,
)

__all__ = ["load_iq", "acquire", "acquire_mxu", "track", "bit_sync",
           "decode_bits", "frame_sync", "parity_ok"]
