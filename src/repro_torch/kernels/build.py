"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes). Libraries land
in ``kernels/_build/`` (git-ignored), named by a hash of the sources and
flags: a changed source rebuilds, an unchanged one loads. ``build_all``
starts one ``nvcc`` per source at once. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}     # name -> library, per process


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin)"
                       ": the CUDA kernels are built on the GPU machine")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):      # every shared header
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, str]:
    """Compile every missing library in parallel; returns name -> ptxas
    report (empty for libraries that were already built). Raises on the
    first failed compile, with nvcc's output."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)            # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def _demangle(sym: str) -> str:
    """Enough of the Itanium mangling for this package's kernels:
    '_ZN4attn14combine_kernelI13__nv_bfloat16EEvPKf...' ->
    'attn::combine_kernel<__nv_bfloat16>', '_Z16flash_mma_kernelILi64EEv...'
    -> 'flash_mma_kernel<64>'; anything else comes back as it is."""
    if not sym.startswith("_Z"):
        return sym
    i = 2
    nested = sym.startswith("N", i)
    i += nested
    parts, args = [], []

    def name_at(i):
        j = i
        while j < len(sym) and sym[j].isdigit():
            j += 1
        n = int(sym[i:j])
        return sym[j:j + n], j + n

    while i < len(sym) and sym[i].isdigit():
        part, i = name_at(i)
        parts.append(part)
        if not nested:
            break
    if sym.startswith("I", i):
        i += 1
        while i < len(sym) and sym[i] != "E":
            if sym[i] == "L":                   # literal: L <type> <value> E
                j = sym.index("E", i)
                args.append(sym[i + 2:j])
                i = j + 1
            elif sym[i].isdigit():
                arg, i = name_at(i)
                args.append(arg)
            else:
                args.append({"f": "float", "i": "int"}.get(sym[i], sym[i]))
                i += 1
    if not parts:
        return sym
    return "::".join(parts) + (f"<{', '.join(args)}>" if args else "")


def ptxas_usage(log: str) -> List[dict]:
    """Per entry function of an ``nvcc -Xptxas -v`` log: its name, the
    registers it uses and its spill stores and loads in bytes."""
    funcs: Dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = funcs.setdefault(m.group(1), dict(
                name=_demangle(m.group(1)), registers=None, spill_stores=0,
                spill_loads=0))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = funcs.get(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return list(funcs.values())


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if its
    sources changed since the last build."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib

