"""Build and bind csrc/synth.cu (the hand-written Hopper synthesis kernel).

The source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use, into build/torch_kernels/ beside the
package, named by the source's hash so an edited source is rebuilt. It is
loaded with ctypes. Nothing here runs at import: the CPU tests import this
module on machines with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "synth.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build csrc/synth.cu")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"synth_{digest[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernel library if this source has not been built yet."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, end="")
        os.replace(tmp, lib)  # atomic: concurrent builds race safely
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.synth_wire_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.synth_wire_iq_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_devices(wire: torch.Tensor, *others: torch.Tensor) -> None:
    for t in others:
        if t.device != wire.device:
            raise ValueError(f"tensor on {t.device}, expected {wire.device}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _call(fn_name: str, wire: torch.Tensor, *args) -> None:
    """Call a launcher of the library on the current stream of wire's
    device and raise on a non-zero cudaGetLastError()."""
    lib = load()
    dev = wire.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")


def launch(wire: torch.Tensor, ca_words: torch.Tensor, table: torch.Tensor,
           out: torch.Tensor, n_chan: int, sub_blocks: int, fmt: int) -> None:
    """Enqueue the packed-word kernel on the current stream of wire's
    device.

    The caller (ops.synth.synth_wire) has checked shapes, types and
    contiguity and allocated `out`; this checks devices and raises on a
    non-zero cudaGetLastError()."""
    _check_devices(wire, ca_words, table, out)
    _call("synth_wire_launch", wire, wire.data_ptr(), ca_words.data_ptr(),
          table.data_ptr(), out.data_ptr(), wire.shape[0], wire.shape[1],
          n_chan, sub_blocks, fmt)


def launch_iq(wire: torch.Tensor, ca_words: torch.Tensor, table: torch.Tensor,
              out_i: torch.Tensor, out_q: torch.Tensor, n_chan: int,
              sub_blocks: int, quantize: bool) -> None:
    """Enqueue the I/Q plane kernel: int16 planes after (acc + 64) >> 7
    (quantize=True) or the raw int32 channel sums (quantize=False).

    The caller (ops.synth.synth_wire_planes / synth_wire_raw) has checked
    the wire and allocated both planes."""
    _check_devices(wire, ca_words, table, out_i, out_q)
    _call("synth_wire_iq_launch", wire, wire.data_ptr(), ca_words.data_ptr(),
          table.data_ptr(), out_i.data_ptr(), out_q.data_ptr(),
          wire.shape[0], wire.shape[1], n_chan, sub_blocks, int(quantize))
