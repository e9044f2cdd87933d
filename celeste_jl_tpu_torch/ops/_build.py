"""Build and bind the package's CUDA kernels.

`nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC` compiles each csrc/*.cu to an object, one nvcc process per source,
all started together (the Jacobi sweeps' two sources, which instantiate
their kernels for 31 matrix sizes, with `--split-compile=0`, their device
code compiled in parallel parts); the objects are linked into one shared
library with a plain C interface, at first use, into build/kernels/ at
the repository root, keyed by a hash of the sources and flags; ctypes
loads it. Nothing outside the repository's sources is built or fetched.
Import builds nothing: the CPU tests import every module on machines
without nvcc.

Each entry point is `celeste_<kernel>_<f32|f64>(pointers..., ints...,
stream)` and returns the launch's cudaGetLastError() as an int. Pointer
arguments are tensors of the kernel's float type, or int32 index tensors.
`celeste_<kernel>_attrs_<f32|f64>` report a redesigned kernel's registers,
local memory, shared memory and resident blocks (`kernel_attrs`).
csrc/tests/*.cu hold checks for the card tests; `build(sources, name)`
builds them into a library of their own.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# the sources compiled in parallel parts, on every core: alone they take
# most of the build
SPLIT_COMPILE = ("jacobi_sweep.cu", "jacobi_sweep_split.cu")

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel -> argument types of its C entry point (the stream comes last)
ENTRY_POINTS = {
    # mu, lv, z, pch, cl4, off, pixels, mask, iota, a0, b0, m15, red |
    # G, C, ks, N, cols | stream
    "refresh": [_P] * 13 + [_I] * 5 + [_P],
    # A, Q, A_out, Q_out | B, D | stream
    "jacobi_sweep": [_P] * 4 + [_I] * 2 + [_P],
    # gq, w, delta, p, pred | B, D, iters | stream
    "tr_subproblem": [_P] * 5 + [_I] * 3 + [_P],
    # A, A_out, cs_log | B, D | stream
    "jacobi_sweep_a": [_P] * 3 + [_I] * 2 + [_P],
    # Q, cs_log, Q_out | B, D | stream
    "jacobi_replay_q": [_P] * 3 + [_I] * 2 + [_P],
    # comps, comp_ptr, meta, tile_ptr, pos, x, iota, bg, order, work, out |
    # n_work, warps | stream
    "mixture_poisson_ll": [_P] * 11 + [_I] * 2 + [_P],
    # the kernels' attributes (`kernel_attrs`): C, warps or D | int[4]
    "refresh_attrs": [_I, _P],
    "mixture_poisson_ll_attrs": [_I, _P],
    "jacobi_sweep_attrs": [_I, _P],
    "tr_subproblem_attrs": [_I, _P],
    "jacobi_sweep_a_attrs": [_I, _P],
    "jacobi_replay_q_attrs": [_I, _P],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_loaded = {}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _headers():
    return [s for s in _sources() if s.endswith(".cuh")]


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build(sources=None, name="celeste_kernels"):
    """Compile `sources` (default csrc/*.cu) into lib<name>_<hash>.so
    unless the library for these sources and csrc/*.cuh exists, and return
    its path. The compiler's report (registers, shared memory, spills per
    kernel) is kept beside it as <library>.ptxas.txt."""
    srcs = _sources() if sources is None else sorted(sources) + _headers()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + list(SPLIT_COMPILE)).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        split = (["--split-compile=0"]
                 if os.path.basename(src) in SPLIT_COMPILE else [])
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *split, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = [p.communicate()[0] for p in procs]
    failed = [r for p, r in zip(procs, reports) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        reports.append(link.stdout)
        if link.returncode != 0:
            failed.append(link.stdout)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    with open(path + ".ptxas.txt", "w") as f:
        f.write("\n".join(reports))
    os.replace(tmp, path)
    return path


def library():
    """The loaded kernel library, built on first use."""
    if "lib" not in _loaded:
        path = build()
        lib = ctypes.CDLL(path)
        for name, argtypes in ENTRY_POINTS.items():
            for suffix in _SUFFIX.values():
                fn = getattr(lib, f"celeste_{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.celeste_error_string.argtypes = [ctypes.c_int]
        lib.celeste_error_string.restype = ctypes.c_char_p
        _loaded["lib"] = lib
    return _loaded["lib"]


def check_cuda(dtype, device):
    """Raise unless (dtype, device) is one a kernel takes."""
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {device} tensor")
    if dtype not in _SUFFIX:
        raise ValueError(f"CUDA kernel takes float32 or float64, not {dtype}")


_entries = {}
# the current stream's handle as an int, without a Stream object (CUDA
# builds of torch)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device):
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _entry(name, dtype):
    """The C entry point of kernel `name` for `dtype`, looked up once."""
    fn = _entries.get((name, dtype))
    if fn is None:
        fn = getattr(library(), f"celeste_{name}_{_SUFFIX[dtype]}")
        _entries[(name, dtype)] = fn
    return fn


def launch(name, dtype, *args):
    """Call kernel `name` for `dtype` on the current stream. Tensor
    arguments must be contiguous, of `dtype` (or int32 indices), on one
    CUDA device; raises if the launch reports an error."""
    fn = _entry(name, dtype)
    device = None
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.dtype not in (dtype, torch.int32) or not a.is_contiguous():
                raise ValueError(f"{name}: needs contiguous {dtype} or int32, "
                                 f"got {a.dtype} contiguous={a.is_contiguous()}")
            if device is None:
                device = a.device
            elif a.device != device:
                raise ValueError(f"{name}: tensors on {device} and {a.device}")
            cargs.append(a.data_ptr())
        else:
            cargs.append(int(a))
    if device.index == torch.cuda.current_device():
        err = fn(*cargs, _stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*cargs, _stream(device))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{library().celeste_error_string(err).decode()}")


def kernel_attrs(name, dtype, arg):
    """What the card reports for kernel `name` ("refresh" with arg = C,
    "mixture_poisson_ll" with arg = warps a block, "jacobi_sweep",
    "jacobi_sweep_a", "jacobi_replay_q" and "tr_subproblem" with arg = D) in
    `dtype`: registers a thread, local memory a thread (stack and spills,
    bytes), shared memory a block (bytes) and resident blocks per SM at
    that configuration."""
    out = (ctypes.c_int * 4)()
    lib = library()
    fn = getattr(lib, f"celeste_{name}_attrs_{_SUFFIX[dtype]}")
    err = fn(int(arg), out)
    if err:
        raise RuntimeError(f"{name} attributes: "
                           f"{lib.celeste_error_string(err).decode()}")
    return dict(registers=out[0], local_bytes=out[1], shared_bytes=out[2],
                blocks_per_sm=out[3])


def ptxas_lines(kernel):
    """nvcc's -Xptxas -v report for the entry functions whose mangled name
    holds `kernel`: one line per compiled instance (stack, spills,
    registers, shared memory)."""
    with open(build() + ".ptxas.txt") as f:
        lines = f.read().splitlines()
    out, keep = [], False
    for line in lines:
        if "Compiling entry function" in line:
            keep = kernel in line
            if keep:
                out.append(line.split("'")[1] + ":")
        elif keep and ("registers" in line or "spill" in line):
            out[-1] += " " + line.split(" : ", 1)[-1].strip()
    return out
