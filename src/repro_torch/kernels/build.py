"""Build the CUDA kernels in `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (an entry point `name`, and
in `mamba_scan.cu` also `mamba_scan_bwd`: `ENTRIES`) and is compiled on
its own with `nvcc` for `sm_90a` into
`build/kernels/<name>-<digest>.so` under the repository root (the digest
covers the source and the flags, so an edited source is rebuilt).
`build_all` starts one `nvcc` per source that is not built yet, all at
once, and waits for them; a kernel's first call builds its own source if
it is missing. Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "access_scan", "migrate", "flash_attention",
           "flash_attention_wgmma", "mamba_scan", "stamp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "paged_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, ctypes.c_longlong, ctypes.c_float,
                        _I, _I, _I, _I, _I, _P),
    "access_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "migrate": (_P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong, _I,
                _P),
    "flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _I,
                        _I, _I, _P),
    "flash_attention_wgmma": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                              ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_float, _I, _I, _P),
    "mamba_scan": (_P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong, _I, _P),
    "mamba_scan_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       ctypes.c_longlong, _I, _P),
    "stamp": (_P, _I, _P),
}
# the source of each C entry point that is not named after its own
ENTRIES = {"mamba_scan_bwd": "mamba_scan"}

_libs: Dict[str, ctypes.CDLL] = {}     # by source
ptxas_logs: Dict[str, str] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every kernel of `names` (by default all) not built yet, one
    nvcc per source, in parallel. Returns {name: ptxas output (registers,
    shared memory, spills)}; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            log = out.with_suffix(".log")
            ptxas_logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        ptxas_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return dict(ptxas_logs)


def lib(entry: str) -> ctypes.CDLL:
    """The loaded library that holds C entry point `entry`, its argument
    types set, building the library first if needed."""
    name = ENTRIES.get(entry, entry)
    if name not in _libs:
        if not _target(name).exists():
            build_all((name,))
        so = ctypes.CDLL(str(_target(name)))
        so.error_string.argtypes = (ctypes.c_int,)
        so.error_string.restype = ctypes.c_char_p
        _libs[name] = so
    so = _libs[name]
    fn = getattr(so, entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
    return so
