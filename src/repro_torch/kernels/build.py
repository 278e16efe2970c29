"""Build the port's CUDA sources into shared libraries and load them.

Every kernel source ``src/repro_torch/csrc/<name>.cu`` exposes a plain C
interface and compiles with ``nvcc`` on its own into
``build/kernels/lib<name>-<digest>.so`` at the repository root, where
``<digest>`` hashes the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  The libraries are loaded with
``ctypes``; nothing here includes PyTorch's headers, which keeps a build
at a few seconds.

Nothing is compiled when this module is imported: ``build`` and ``load``
run at a kernel's first launch (or when a caller asks, as
``chip_smoke.py`` does to time the build).  Run as a script on a machine
with nvcc, it prints what ptxas reports for each kernel of the named
sources (all by default): registers a thread and bytes spilled,

    PYTHONPATH=src python3 -m repro_torch.kernels.build flash_attention
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "ptxas_report"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
SOURCES = ("hellinger_strip", "fedavg_reduce", "flash_attention", "mamba_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME): the "
            "port's CUDA kernels are built from source at first use"
        )
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together.  Returns name -> library
    path.  Raises ``RuntimeError`` with the compiler's output if any
    build fails."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, t in todo.items():
        tmp = t.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _loaded[name] = lib
    return lib


_ITANIUM_ARGS = re.compile(r"f|13__nv_bfloat16|Li(\d+)E|Lb([01])E")


def _kernel_name(mangled: str) -> str:
    """``fwd_kernel<float, 80>`` from the mangled name of a kernel in an
    anonymous namespace (the port's sources' only kind); the name as it is
    where the pattern does not fit."""
    m = re.search(r"\d([a-z][a-z_]*_kernel)I(\w+?)EEv", mangled)
    if m is None:
        plain = re.search(r"\d([a-z][a-z_]*_kernel)", mangled)
        return plain.group(1) if plain else mangled
    args, pos = [], 0
    while pos < len(m.group(2)):
        a = _ITANIUM_ARGS.match(m.group(2), pos)
        if a is None:
            return mangled
        args.append({"f": "float", "13__nv_bfloat16": "bf16"}.get(a.group(0))
                    or a.group(1) or ("true" if a.group(2) == "1" else "false"))
        pos = a.end()
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_report(name: str) -> list[dict]:
    """Compile ``csrc/<name>.cu`` with ``-Xptxas -v`` into a scratch library
    and return, for each kernel, its registers a thread and the bytes it
    spills (stores and loads)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"report-{name}.{os.getpid()}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                           str(CSRC / f"{name}.cu")], capture_output=True, text=True)
    out.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}{proc.stderr}")
    rows, kernel, spills = [], None, (0, 0)
    for line in (proc.stdout + proc.stderr).splitlines():
        if (m := re.search(r"Compiling entry function '(\w+)'", line)):
            kernel = _kernel_name(m.group(1))
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and kernel is not None:
            rows.append({"kernel": kernel, "registers": int(m.group(1)),
                         "spill_stores": spills[0], "spill_loads": spills[1]})
            kernel, spills = None, (0, 0)
    return rows


if __name__ == "__main__":
    for source in sys.argv[1:] or SOURCES:
        for row in ptxas_report(source):
            print(f"{source}: {row['kernel']:36s} registers {row['registers']:3d}  "
                  f"spill stores {row['spill_stores']:4d} B  loads {row['spill_loads']:4d} B")
