"""Build and load the hand-written CUDA kernels of ``stencil_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``. The
kernels build on first use, all in parallel (one ``nvcc`` per source,
started together), into ``stencil_tpu_torch/_build/`` (git-ignored). A
library is named after the hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is reused.

Floating point: no fast math, ``-prec-div=true -ftz=false -fmad=false``, so
every operation rounds exactly as written and the kernels can be held equal
to their plain PyTorch versions bit for bit.

Nothing here runs on import; on a machine without ``nvcc`` only the first
kernel launch fails, with the reason.

Several processes may build at once (the ranks of a run on one card): the
builds take a file lock on the build directory (``fcntl``), so the first
rank compiles and the others find its libraries and load them.

The host-side C++ of ``stencil_tpu_torch/csrc_host`` (the ParaView writer)
is built the same way by ``g++`` (:func:`build_host`).

:data:`first_use` counts the work a warmed-up loop never does again, the
port's counterpart of a JAX compile: kernel and host library builds and
loads, table uploads (a :func:`kept` or :func:`device_table` miss), CUDA
graph captures and step-loop builds. ``analysis/jit_audit`` fails a loop
that does any of it after its warm-up.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-prec-div=true", "-prec-sqrt=true", "-ftz=false", "-fmad=false",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry points: name -> (restype, argtypes)
SIGNATURES = {
    "jacobi_sweep": {
        "jacobi_sweep_launch": (_I, [_P, _I, _I, _L, _L, _L, _L, _I, _I, _I, _I, _P]),
        "jacobi_sweep_info": (_I, [_I, _I, ctypes.POINTER(_I)]),
    },
    "jacobi_multistep": {
        "jacobi_multistep_launch": (_I, [_P, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I,
                                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
        "jacobi_multistep_positions_launch": (_I, [_P, _I, _I, _L, _L, _I, _I, _I, _I, _I,
                                                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                                   _I, _P]),
        "jacobi_multistep_smem_bytes": (_L, [_I, _I]),
        "jacobi_multistep_info": (_I, [_I, _I, _I, _I, ctypes.POINTER(_I)]),
    },
    "self_fill": {
        "self_fill_launch": (_I, [ctypes.POINTER(_P), _I, _I, _I, ctypes.POINTER(_L), _L,
                                  _L, _I, _P]),
    },
    "fused_jacobi": {
        "fused_jacobi_launch": (_I, [_P, _I, _I, _P, _I, _P, _I, _I, _L, _L, _L, _I, _I, _I,
                                     _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_double), _I,
                                     _P]),
        "fused_jacobi_info": (_I, [_I, _I, ctypes.POINTER(_I)]),
        "fused_jacobi_zchunks": (_I, [_I, _I, _I, _I, _I, _I]),
    },
    "persistent_jacobi": {
        "persistent_jacobi_launch": (_I, [_P, _I, _I, _P, _I, ctypes.POINTER(_I), _I, _P, _L,
                                          _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
        "persistent_jacobi_passes": (_I, [_I, ctypes.POINTER(_I), _I]),
        "persistent_jacobi_smem_bytes": (_L, [_I]),
        "persistent_jacobi_blocks_per_sm": (_I, [_I, _I, ctypes.POINTER(_I)]),
        "persistent_jacobi_threads": (_I, [_I]),
    },
    "remote_axis": {
        "remote_axis_launch": (_I, [_P, _I, _P, _I, _L, _I, _I, ctypes.POINTER(ctypes.c_double),
                                    _L, _L, _P]),
        "remote_axis_info": (_I, [_I, _I, ctypes.POINTER(_I)]),
    },
    "fused_exchange": {
        "fused_exchange_launch": (_I, [_P, _I, _P, _I, _L, _I, _I,
                                       ctypes.POINTER(ctypes.c_double), _L, _L, _P]),
    },
    "astaroth_substep": {
        "astaroth_substep_launch": (_I, [ctypes.POINTER(_P), ctypes.POINTER(_P), _I,
                                         ctypes.POINTER(ctypes.c_double), _I, _I,
                                         ctypes.POINTER(_I), _I, _I, _L, _L, _L, _I, _I, _I,
                                         _P]),
        "astaroth_substep_info": (_I, [_I, _I, _I, ctypes.POINTER(_I)]),
        "astaroth_substep_positions_launch": (_I, [ctypes.POINTER(_P), ctypes.POINTER(_P), _I,
                                                   _I, ctypes.POINTER(ctypes.c_double), _I, _I,
                                                   ctypes.POINTER(_I), _I, _I, _L, _L, _L, _I,
                                                   _I, _I, _P]),
        "astaroth_substep_positions_info": (_I, [_I, _I, _I, ctypes.POINTER(_I)]),
    },
    "health_reduce": {
        "health_reduce_launch": (_I, [_P, _L, _P, _I, _P, _I, _P]),
        "health_reduce_task_bytes": (_L, []),
    },
    # no kernel: CUDA IPC handles and interprocess events (parallel/ipc.py)
    "ipc": {
        "ipc_mem_handle": (_I, [_P, _P, ctypes.POINTER(_L)]),
        "ipc_open_mem": (_I, [_P, ctypes.POINTER(_P)]),
        "ipc_close_mem": (_I, [_P]),
        "ipc_event_create": (_I, [ctypes.POINTER(_P)]),
        "ipc_event_handle": (_I, [_P, _P]),
        "ipc_open_event": (_I, [_P, ctypes.POINTER(_P)]),
        "ipc_event_record": (_I, [_P, _P]),
        "ipc_stream_wait": (_I, [_P, _P]),
        "ipc_event_destroy": (_I, [_P]),
    },
}

# libraries a source links beside the CUDA runtime (ipc.cu reaches
# libcuda.so.1 through dlopen)
LINK_FLAGS = {"ipc": ("-ldl",)}


@dataclass
class BuildInfo:
    """What the last build did: seconds, and each library's ptxas report."""

    seconds: float = 0.0
    ptxas: Dict[str, str] = field(default_factory=dict)
    built: Dict[str, bool] = field(default_factory=dict)


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_info = BuildInfo()

first_use = {"build": 0, "table": 0, "graph": 0, "loop": 0}


def note_first_use(kind: str) -> None:
    """Count one piece of first-use work of ``kind`` (a key of
    :data:`first_use`)."""
    first_use[kind] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: str, name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS.get(name, ())).encode())
    # the headers are hashed into every library: any of them may be included
    for path in [src] + [os.path.join(CSRC, f) for f in sorted(os.listdir(CSRC))
                         if f.endswith(".cuh")]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(src: str, name: str):
    """``(library path, nvcc process or None)``: the compile of ``src`` into
    ``lib<name>-<hash>.so``, started unless that library exists."""
    out = _lib_path(src, name)
    build_info.built[name] = not os.path.exists(out)
    if not build_info.built[name]:
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src, *LINK_FLAGS.get(name, ())],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(src: str, name: str, out: str, job) -> None:
    """Wait for a compile :func:`_start` began; raise with its output if it
    failed."""
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    build_info.ptxas[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {os.path.basename(src)} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)


@contextlib.contextmanager
def build_lock():
    """An exclusive lock on the build directory, held across processes
    (``fcntl.flock`` on its ``.lock`` file), so that ranks starting together
    build each library once."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(src: str, name: str) -> ctypes.CDLL:
    """``src`` (a ``.cu`` file with a plain C interface) compiled with the
    kernels' flags into their build directory, once per content, and
    loaded. The caller sets its entry points' types."""
    note_first_use("build")
    with build_lock():
        out, job = _start(src, name)
        _finish(src, name, out, job)
    return ctypes.CDLL(out)


def _src(name: str) -> str:
    return os.path.join(CSRC, name + ".cu")


def build_all() -> BuildInfo:
    """Compile every missing library of ``csrc``, one ``nvcc`` per source,
    in parallel. Raises with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    failed = []
    with build_lock():
        jobs = {name: _start(_src(name), name) for name in SIGNATURES}
        for name, (out, job) in jobs.items():
            try:
                _finish(_src(name), name, out, job)
            except RuntimeError as e:
                failed.append(str(e))
    build_info.seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return build_info


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    with _lock:
        if not _libs:
            note_first_use("build")
            build_all()
            for n, fns in SIGNATURES.items():
                so = ctypes.CDLL(_lib_path(_src(n), n))
                for fn, (res, args) in fns.items():
                    getattr(so, fn).restype = res
                    getattr(so, fn).argtypes = args
                _libs[n] = so
        return _libs[name]


CSRC_HOST = os.path.join(os.path.dirname(CSRC), "csrc_host")
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Wextra")
_host_libs: Dict[str, ctypes.CDLL] = {}


def build_host(name: str) -> ctypes.CDLL:
    """``csrc_host/<name>.cpp`` (host C++ with a plain C interface) compiled
    by ``g++`` into the build directory once per content and flags, and
    loaded (once per process). Raises with the compiler's output when the
    build fails; the caller sets its entry points' types."""
    with _lock:
        if name in _host_libs:
            return _host_libs[name]
        note_first_use("build")
        src = os.path.join(CSRC_HOST, name + ".cpp")
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        with open(src, "rb") as f:
            h.update(f.read())
        out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
        with build_lock():
            _build_host(out, src, name)
        _host_libs[name] = ctypes.CDLL(out)
        return _host_libs[name]


def _build_host(out: str, src: str, name: str) -> None:
    """g++ of ``src`` into ``out`` unless it exists (under the build lock)."""
    if os.path.exists(out):
        return
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError(f"no C++ compiler (g++) on PATH: {name}.cpp cannot be built")
    tmp = f"{out}.{os.getpid()}.tmp"
    p = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, src], capture_output=True, text=True,
                       timeout=300)
    if p.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cpp (rc {p.returncode}):\n"
                           f"{p.stdout}{p.stderr}")
    os.replace(tmp, out)


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (its launch was
    refused, or a previous asynchronous fault surfaced)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# pointer tables of the mesh kernels (and the carriers' launch arguments),
# on their device, by content
_tables: "OrderedDict[tuple, object]" = OrderedDict()
MAX_TABLES = 64


def kept(key, make):
    """``make()``, made once per ``key`` (which must determine it) and kept
    for the newest :data:`MAX_TABLES` keys used."""
    t = _tables.get(key)
    if t is None:
        note_first_use("table")
        t = make()
        _tables[key] = t
        if len(_tables) > MAX_TABLES:
            _tables.popitem(last=False)
    else:
        _tables.move_to_end(key)
    return t


def upload(values, device):
    """``values`` (a list of ints) as an int64 tensor on ``device``."""
    import torch

    return torch.tensor(values, dtype=torch.int64).to(device)


def device_table(key, rows, device):
    """The int64 table a mesh kernel reads its (source, destination) pointer
    rows from, on ``device``: ``rows()`` (a list of ints), made once per
    ``key`` (which must determine the rows, e.g. the geometry and the
    blocks' pointers) and kept for the newest :data:`MAX_TABLES` keys, so a
    loop over the same tensors uploads each table once. A launch under
    CUDA-graph capture must find its table already made."""
    return kept((str(device), key), lambda: upload(rows(), device))


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer value."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
