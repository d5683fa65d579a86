"""Build the port's CUDA sources, and bind csrc/synth.cu (the hand-written
Hopper synthesis kernels: the wire form and the row form) and
csrc/synth_profile.cu (its ablated instantiations, for cost attribution).

`build(source)` compiles one source of csrc/ with nvcc for sm_90a into a
shared library with a plain C interface, at first use, into
build/torch_kernels/ beside the package, named by the source's stem and
the hash of it and the csrc/ files it includes, so an edited source is
rebuilt. Libraries are loaded with ctypes (csrc/synth.cu here,
csrc/vpu_peak.cu by tools/vpu_peak.py). Nothing here runs at import: the
CPU tests import this module on machines with no nvcc and no card.

The ablated kernels (`launch_ablated`) write wrong samples by design. Only
tools/profile_kernel.py, tools/op_budget.py and chip_smoke.py reach them
(tests/test_torch_profile.py holds that): nothing on the runner, CLI,
parallel or ops path does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "synth.cu"
PROFILE_SOURCE = _PKG / "csrc" / "synth_profile.cu"
VPU_PEAK_SOURCE = _PKG / "csrc" / "vpu_peak.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None
_profile_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA sources")


def library_path(source: pathlib.Path = SOURCE) -> pathlib.Path:
    text = source.read_bytes()
    for name in re.findall(rb'#include "([^"]+)"', text):
        text += (source.parent / name.decode()).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}_{digest[:16]}.so"


def build(source: pathlib.Path = SOURCE) -> pathlib.Path:
    """Compile `source` into its library if this source has not been built
    yet; returns the library's path. What -Xptxas -v says (registers,
    shared memory, spills of each kernel) goes to build_log(library)."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: concurrent builds race safely
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_log(lib: pathlib.Path) -> str:
    """The compiler's output (-Xptxas -v) of a library that build() made."""
    return lib.with_suffix(".log").read_text()


def ptxas_usage(text: str) -> dict:
    """{mangled kernel name: {"registers", "smem_bytes", "spill_stores",
    "spill_loads"}} from the text of -Xptxas -v."""
    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            usage[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            usage[name].update(registers=int(m.group(1)),
                               smem_bytes=int(smem.group(1)) if smem else 0)
            name = None
    return usage


# The output mode and format of each synth_wire_kernel<MODE, FMT, NAV>
# instantiation, by wrapper (the launch-count key), and of each
# synth_rows_kernel<MODE>.
_WIRE_KEYS = {("0", "16"): "synth_wire/16", ("0", "8"): "synth_wire/8",
              ("0", "1"): "synth_wire/1", ("1", "0"): "synth_wire_planes",
              ("2", "0"): "synth_wire_raw"}
_ROW_KEYS = {"1": "synth_rows_planes", "2": "synth_rows_raw"}
# Samples one thread owns, so one trip of its channel loop covers
# (csrc/synth.cu kSamplesPerThread).
SAMPLES_PER_TRIP = 16


def instantiation_key(mangled: str):
    """The key of a synthesis kernel instantiation (synth_wire/16,
    synth_wire/8, synth_wire/1, synth_wire_planes, synth_wire_raw, the same
    with _nav for the mask-table variant, synth_rows_planes,
    synth_rows_raw), or None for another function."""
    m = re.match(r"\S*synth_wire_kernelILi(\d)ELi(\d+)ELb([01])E", mangled)
    if m:
        key = _WIRE_KEYS[m.groups()[:2]]
        if m.group(3) == "0":
            return key
        base, sep, fmt = key.partition("/")
        return f"{base}_nav{sep}{fmt}"
    r = re.match(r"\S*synth_rows_kernelILi(\d)E", mangled)
    return _ROW_KEYS[r.group(1)] if r else None


# The cost centres of csrc/synth.cu's Ablate bits, by the Pallas kernel's
# `ablate` names, and the four sets that csrc/synth_profile.cu
# instantiates (kPacked, walk, SC16/SC08/SC01 each).
ABLATE_BITS = {"no_trig_gather": 1, "no_ca_gather": 2, "no_nav_walk": 4}
ABLATION_SETS = {
    "no_trig_gather": frozenset({"no_trig_gather"}),
    "no_ca_gather": frozenset({"no_ca_gather"}),
    "no_nav_walk": frozenset({"no_nav_walk"}),
    "no_gathers": frozenset({"no_trig_gather", "no_ca_gather"}),
}
PROFILE_FORMATS = (16, 8, 1)


def ablate_mask(ablate) -> int:
    """The Ablate bits of a set of cost-centre names; raises ValueError
    unless it is one of ABLATION_SETS."""
    ablate = frozenset(ablate)
    if ablate not in ABLATION_SETS.values():
        raise ValueError(f"ablation set {sorted(ablate)} is not one of "
                         f"{sorted(ABLATION_SETS)}")
    return sum(ABLATE_BITS[name] for name in ablate)


def profile_instantiation_key(mangled: str):
    """The key of an ablated instantiation of csrc/synth_profile.cu,
    synth_wire/<fmt>/<set name> (e.g. synth_wire/16/no_gathers), or None
    for another function."""
    m = re.match(r"\S*synth_profile_kernelILi(\d+)ELi(\d+)E", mangled)
    if not m:
        return None
    by_mask = {ablate_mask(v): k for k, v in ABLATION_SETS.items()}
    return f"synth_wire/{m.group(1)}/{by_mask[int(m.group(2))]}"


def all_profile_keys() -> list:
    return [f"synth_wire/{fmt}/{name}" for fmt in PROFILE_FORMATS
            for name in ABLATION_SETS]


def all_instantiation_keys() -> list:
    keys = list(_WIRE_KEYS.values())
    keys += [instantiation_key(f"synth_wire_kernelILi{m}ELi{f}ELb1E")
             for m, f in _WIRE_KEYS]
    return keys + list(_ROW_KEYS.values())


def channel_loops(loops: dict, key_of=instantiation_key,
                  keys=None) -> dict:
    """{key: one trip of its channel loop} of each synthesis instantiation,
    from sass_loops: the channel loop is the kernel's longest loop, kept
    rolled (csrc/synth.cu), one trip per (thread, channel) covering the
    SAMPLES_PER_TRIP samples the thread owns. Keys by `key_of`
    (instantiation_key, or profile_instantiation_key for the ablated
    library); raises AssertionError unless they are exactly `keys`
    (default all_instantiation_keys())."""
    found = {}
    for fn, fn_loops in loops.items():
        key = key_of(fn)
        if key is None:
            continue
        loop = max(fn_loops, key=len, default=[])
        if len(loop) < SAMPLES_PER_TRIP:
            raise AssertionError(f"no channel loop found in {fn}")
        found[key] = loop
    want = all_instantiation_keys() if keys is None else keys
    if sorted(found) != sorted(want):
        raise AssertionError(f"SASS holds kernels {sorted(found)}")
    return found


def channel_loop_instructions(loops: dict) -> dict:
    """SASS instructions per (sample, channel) of each production synthesis
    instantiation: its channel loop's length (channel_loops) over
    SAMPLES_PER_TRIP, the channel's per-thread setup included. Keys as
    instantiation_key."""
    return {key: len(loop) / SAMPLES_PER_TRIP
            for key, loop in channel_loops(loops).items()}


def sass(lib: pathlib.Path) -> str:
    """The text of `cuobjdump -sass` for a built library."""
    tool = pathlib.Path(nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def sass_loops(text: str) -> dict:
    """{mangled kernel name: [loop, ...]} from the text of `cuobjdump
    -sass`. A loop is the opcodes from a backward branch's target to the
    branch, predicates stripped and NOPs dropped, so its length is what one
    trip issues."""
    loops = {}
    for block in re.split(r"Function : ", text)[1:]:
        ins = []
        for addr, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                   block):
            words = op.split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                ins.append((int(addr, 16), words))
        index = {a: i for i, (a, _) in enumerate(ins)}
        found = []
        for i, (a, words) in enumerate(ins):
            if words[0] != "BRA" or len(words) < 2:
                continue
            target = int(words[1].strip("`()"), 16)
            if target < a and target in index:
                found.append([w[0] for _, w in ins[index[target]:i + 1]
                              if w[0] != "NOP"])
        loops[block.split(None, 1)[0]] = found
    return loops


def load_profile():
    """The library of csrc/synth_profile.cu (built at first use)."""
    global _profile_lib
    if _profile_lib is None:
        lib = ctypes.CDLL(str(build(PROFILE_SOURCE)))
        fn = lib.synth_profile_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _profile_lib = lib
    return _profile_lib


def load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.synth_wire_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.synth_wire_iq_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.synth_rows_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
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


def call(lib, fn_name: str, dev: torch.device, *args) -> None:
    """Call launcher `fn_name` of `lib` on the current stream of device
    `dev` and raise on a non-zero cudaGetLastError()."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")


def launch(wire: torch.Tensor, ca_words: torch.Tensor, table: torch.Tensor,
           out: torch.Tensor, n_chan: int, sub_blocks: int, fmt: int,
           nav_gather: bool) -> None:
    """Enqueue the packed-word kernel (the nav mask-table variant when
    nav_gather) on the current stream of wire's device.

    The caller (ops.synth.synth_wire) has checked shapes, types and
    contiguity and allocated `out`; this checks devices and raises on a
    non-zero cudaGetLastError()."""
    _check_devices(wire, ca_words, table, out)
    call(load(), "synth_wire_launch", wire.device, wire.data_ptr(),
         ca_words.data_ptr(), table.data_ptr(), out.data_ptr(),
         wire.shape[0], wire.shape[1], n_chan, sub_blocks, fmt,
         int(nav_gather))


def launch_ablated(wire: torch.Tensor, ca_words: torch.Tensor,
                   table: torch.Tensor, out: torch.Tensor, n_chan: int,
                   sub_blocks: int, fmt: int, ablate) -> None:
    """Enqueue the ablated packed walk kernel of set `ablate` (one of
    ABLATION_SETS) on the current stream of wire's device, as launch()
    does the production one. Its words are wrong by design."""
    mask = ablate_mask(ablate)
    _check_devices(wire, ca_words, table, out)
    call(load_profile(), "synth_profile_launch", wire.device,
         wire.data_ptr(), ca_words.data_ptr(), table.data_ptr(),
         out.data_ptr(), wire.shape[0], wire.shape[1], n_chan, sub_blocks,
         fmt, mask)


def launch_iq(wire: torch.Tensor, ca_words: torch.Tensor, table: torch.Tensor,
              out_i: torch.Tensor, out_q: torch.Tensor, n_chan: int,
              sub_blocks: int, quantize: bool, nav_gather: bool) -> None:
    """Enqueue the I/Q plane kernel: int16 planes after (acc + 64) >> 7
    (quantize=True) or the raw int32 channel sums (quantize=False).

    The caller (ops.synth.synth_wire_planes / synth_wire_raw) has checked
    the wire and allocated both planes."""
    _check_devices(wire, ca_words, table, out_i, out_q)
    call(load(), "synth_wire_iq_launch", wire.device, wire.data_ptr(),
         ca_words.data_ptr(), table.data_ptr(), out_i.data_ptr(),
         out_q.data_ptr(), wire.shape[0], wire.shape[1], n_chan, sub_blocks,
         int(quantize), int(nav_gather))


def launch_rows(rows: torch.Tensor, ca_words: torch.Tensor,
                table: torch.Tensor, out_i: torch.Tensor, out_q: torch.Tensor,
                quantize: bool) -> None:
    """Enqueue the row-form kernel on [B, SB, C, 12] rows: int16 planes
    after (acc + 64) >> 7 (quantize=True) or the raw int32 channel sums.

    The caller (ops.synth.synth_rows_planes / synth_rows_raw) has checked
    the rows and allocated both planes."""
    _check_devices(rows, ca_words, table, out_i, out_q)
    B, SB, C = rows.shape[:3]
    call(load(), "synth_rows_launch", rows.device, rows.data_ptr(),
         ca_words.data_ptr(), table.data_ptr(), out_i.data_ptr(),
         out_q.data_ptr(), B, SB, C, int(quantize))
