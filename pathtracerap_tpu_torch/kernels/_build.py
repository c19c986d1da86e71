"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` (one process per source, all started
together) and links the objects into one shared library with a plain C
interface, loaded with ``ctypes``.  The build happens at first use into
``build/pathtracerap_tpu_torch/`` beside the package and is keyed by a hash
of the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  Each C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; :func:`check` raises on non-zero.

The traversal keeps IEEE semantics: no ``--use_fast_math`` (the accept
chain relies on NaN comparing false), and ``-fmad=false`` so that a
``a * b + c`` in the kernels rounds twice, as the plain PyTorch versions'
separate elementwise ops do; the kernels call ``fmaf`` where the plain
versions fuse (matrix products, ``addcmul``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pathtracerap_tpu_torch"
ARCH = "arch=compute_90a,code=sm_90a"

FLAGS = [
    "-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v", "-lineinfo",
]

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.ptt_trace_list.restype = i
    lib.ptt_trace_list.argtypes = [p, p, i, i, i, i, p, i, p, p, p, i, p]
    lib.ptt_bounce.restype = i
    lib.ptt_bounce.argtypes = [p, p, p, i, i, i, i, i, p, i, p, i, i, p, p, p, i, p]
    lib.ptt_bounce_trace.restype = i
    lib.ptt_bounce_trace.argtypes = [p, p, i, i, i, i, p, i, p, p, p]
    lib.ptt_sample_fused.restype = i
    lib.ptt_sample_fused.argtypes = [p, p, p, i, i, i, p, i, p, i, p, p, i, i, i, i, i, p, p, p, i,
                                     p]
    lib.ptt_nearest_hit.restype = i
    lib.ptt_nearest_hit.argtypes = [p, p, p, p, i, p, p, p, i, i, i, p, p, p, p, p]
    lib.ptt_prof_parts.restype = i
    lib.ptt_prof_parts.argtypes = [p, i, i, i, p, i, p, i, p, i, i, i, i, p, p]
    lib.ptt_prof_parts_smem.restype = i
    lib.ptt_prof_parts_smem.argtypes = [i, i, i, p]
    lib.ptt_prof_argmin.restype = i
    lib.ptt_prof_argmin.argtypes = [p, i, i, p, p, i, p]
    lib.ptt_noop.restype = i
    lib.ptt_noop.argtypes = [i, i, p]
    lib.ptt_grid_dda.restype = i
    lib.ptt_grid_dda.argtypes = [p, p, p, i, p, i, *[p] * 8, *[i] * 11, *[p] * 11]
    lib.ptt_grid_dda_blocks_per_sm.restype = i
    lib.ptt_grid_dda_blocks_per_sm.argtypes = [i, i, p]
    lib.ptt_chunk_uniforms.restype = i
    lib.ptt_chunk_uniforms.argtypes = [p, u, i, i, i, i, i, i, u, p, p]
    lib.ptt_defer_shade.restype = i
    lib.ptt_defer_shade.argtypes = [p, p, p, p, i, p, i, i, p, i, i, p, p]
    lib.ptt_defer_shade_primary.restype = i
    lib.ptt_defer_shade_primary.argtypes = [*[p] * 7, i, p, i, i, i, p, i, i, i, p, p]
    lib.ptt_error_string.restype = ctypes.c_char_p
    lib.ptt_error_string.argtypes = [i]
    return lib


def library() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libptt_{h.hexdigest()[:16]}.so"
    if not so.exists():
        objs = BUILD_DIR / f"obj_{h.hexdigest()[:16]}_{os.getpid()}"
        objs.mkdir(parents=True, exist_ok=True)
        procs = [
            subprocess.Popen(
                [_nvcc(), *FLAGS, "-c", "-I", str(CSRC), "-o", str(objs / f"{src.stem}.o"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src in sources
        ]
        logs = [p.communicate()[0] for p in procs]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run(
                [_nvcc(), "-shared", "-gencode", ARCH, "-o", str(tmp),
                 *(str(objs / f"{src.stem}.o") for src in sources)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            logs.append(link.stdout)
            procs.append(link)
        so.with_suffix(".log").write_text("".join(logs))
        failed = [p.returncode for p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{''.join(logs)[-4000:]}")
        os.replace(tmp, so)
    _lib = _bind(ctypes.CDLL(str(so)))
    return _lib


def build_log() -> str:
    """nvcc's output for the loaded library (with ``-Xptxas -v``: the
    registers and shared memory of each kernel)."""
    log = Path(library()._name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def kernel_resources(log: str = None) -> dict:
    """Per compiled kernel (its mangled name), what ``ptxas -v`` reports:
    ``{"registers", "spill_stores", "spill_loads", "smem"}`` (bytes for
    the last three), from ``log`` or the loaded library's build log."""
    out, name = {}, None
    for line in (build_log() if log is None else log).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "spill_stores": 0, "spill_loads": 0, "smem": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(sm.group(1)) if sm else 0
    return out


def check(err: int, what: str) -> None:
    if err:
        msg = library().ptt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
