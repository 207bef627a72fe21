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
"""

from __future__ import annotations

import ctypes
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
        "jacobi_multistep_smem_bytes": (_L, [_I, _I]),
        "jacobi_multistep_info": (_I, [_I, _I, _I, _I, ctypes.POINTER(_I)]),
    },
    "self_fill": {
        "self_fill_launch": (_I, [ctypes.POINTER(_P), _I, _I, _I, ctypes.POINTER(_L), _L,
                                  _L, _I, _P]),
    },
    "fused_jacobi": {
        "fused_jacobi_launch": (_I, [_P, _I, _P, _I, _P, _I, _I, _L, _L, _L, _I, _I, _I,
                                     _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_double), _I,
                                     _P]),
        "fused_jacobi_info": (_I, [_I, _I, ctypes.POINTER(_I)]),
        "fused_jacobi_zchunks": (_I, [_I, _I, _I, _I, _I, _I]),
    },
    "persistent_jacobi": {
        "persistent_jacobi_launch": (_I, [_P, _I, _P, _I, ctypes.POINTER(_I), _I, _L, _L,
                                          _I, _I, _I, _I, _I, _I, _I, _I, _P]),
        "persistent_jacobi_uneven_launch": (_I, [_P, _I, _P, _L, _L, _I, _I, _I, _I, _I, _I,
                                                 _I, _I, _P]),
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
}


@dataclass
class BuildInfo:
    """What the last build did: seconds, and each library's ptxas report."""

    seconds: float = 0.0
    ptxas: Dict[str, str] = field(default_factory=dict)
    built: Dict[str, bool] = field(default_factory=dict)


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_info = BuildInfo()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: str, name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
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


def build(src: str, name: str) -> ctypes.CDLL:
    """``src`` (a ``.cu`` file with a plain C interface) compiled with the
    kernels' flags into their build directory, once per content, and
    loaded. The caller sets its entry points' types."""
    out, job = _start(src, name)
    _finish(src, name, out, job)
    return ctypes.CDLL(out)


def _src(name: str) -> str:
    return os.path.join(CSRC, name + ".cu")


def build_all() -> BuildInfo:
    """Compile every missing library of ``csrc``, one ``nvcc`` per source,
    in parallel. Raises with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    jobs = {name: _start(_src(name), name) for name in SIGNATURES}
    failed = []
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
            build_all()
            for n, fns in SIGNATURES.items():
                so = ctypes.CDLL(_lib_path(_src(n), n))
                for fn, (res, args) in fns.items():
                    getattr(so, fn).restype = res
                    getattr(so, fn).argtypes = args
                _libs[n] = so
        return _libs[name]


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
