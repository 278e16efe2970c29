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

``count_launch`` counts a wrapper's launches.  ``work_tally`` collects,
while it is active, what each kernel call does (its ``Work``: the
product flops that the reference's graph has for the same function, the
kernel's own flops, its bytes; from the work formula beside each
wrapper) on CUDA and ``meta`` tensors alike, and each collective's bytes
(``tally_collective``): the dry run's counts and the card's are the same.
``kernel_path`` says where a wrapper sends a tensor: CUDA tensors to the
kernel, ``meta`` tensors to its ``meta`` branch (the outputs, no launch)
or, inside ``plain_on_meta``, to the plain version, as CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "ptxas_report", "count_launch", "Work",
           "WorkTally", "work_tally", "tally_kernel", "tally_collective", "plain_on_meta",
           "kernel_path", "launch_or_meta"]

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


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: in ``wrapper.captured``
    while the current stream is being captured into a CUDA graph (the
    launch then runs at each replay, not now, and whoever replays the graph
    counts the replays), else in ``wrapper.launches``."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


# ---------------------------------------------------------------------------
# The work tally: what each kernel call and each collective does
# ---------------------------------------------------------------------------


class Work(NamedTuple):
    """One kernel call's work: ``product_flops``, the flops of the matrix
    products that the reference's graph has for the same function (the
    dry run's ``flops`` count); ``flops``, the kernel's own; ``bytes``,
    its inputs read once and its outputs written once."""
    product_flops: float
    flops: float
    bytes: float


@dataclass
class WorkTally:
    """The work of the kernel calls and collectives made while it is
    active: ``kernels`` name -> {"launches", "product_flops", "flops",
    "bytes"}, ``collectives`` kind -> result bytes."""
    kernels: dict = field(default_factory=dict)
    collectives: dict = field(default_factory=dict)

    @property
    def product_flops(self) -> float:
        return sum(k["product_flops"] for k in self.kernels.values())

    @property
    def bytes(self) -> float:
        return sum(k["bytes"] for k in self.kernels.values())


_TALLIES: list[WorkTally] = []
_PLAIN_ON_META: list[bool] = [False]


@contextmanager
def work_tally():
    """A ``WorkTally`` that every kernel wrapper (on CUDA and ``meta``
    tensors alike) and every collective of a mesh adds to while the block
    runs.  Tallies nest: each active one counts."""
    tally = WorkTally()
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def tally_kernel(name: str, work: Work) -> None:
    """Add one call of kernel ``name`` and its ``work`` to every active tally."""
    for tally in _TALLIES:
        rec = tally.kernels.setdefault(
            name, {"launches": 0, "product_flops": 0.0, "flops": 0.0, "bytes": 0.0})
        rec["launches"] += 1
        rec["product_flops"] += work.product_flops
        rec["flops"] += work.flops
        rec["bytes"] += work.bytes


def tally_collective(kind: str, n_bytes: float) -> None:
    """Add a collective's result bytes under ``kind`` (``all-reduce``,
    ``all-gather``, ...) to every active tally."""
    for tally in _TALLIES:
        tally.collectives[kind] = tally.collectives.get(kind, 0.0) + float(n_bytes)


@contextmanager
def plain_on_meta():
    """While the block runs, a kernel wrapper given ``meta`` tensors runs
    its plain version on them (the path CPU tensors take), instead of its
    ``meta`` branch (the path CUDA tensors take)."""
    _PLAIN_ON_META.append(True)
    try:
        yield
    finally:
        _PLAIN_ON_META.pop()


def kernel_path(t) -> str:
    """Where a wrapper sends tensors on ``t``'s device: ``"cuda"`` (launch
    the kernel), ``"meta"`` (the kernel's outputs and work, no data) or
    ``"plain"`` (the plain version: CPU tensors, and ``meta`` ones inside
    ``plain_on_meta``)."""
    kind = t.device.type
    if kind == "meta":
        return "plain" if _PLAIN_ON_META[-1] else "meta"
    return "cuda" if kind == "cuda" else "plain"


def launch_or_meta(t, what: str) -> bool:
    """For a function that launches a kernel: True for CUDA tensors, False
    for ``meta`` ones (their outputs and work, no launch); raises for
    tensors that the plain version takes."""
    path = kernel_path(t)
    if path == "plain":
        raise ValueError(f"{what} launches the kernel: pass CUDA (or meta) tensors")
    return path == "cuda"


if __name__ == "__main__":
    for source in sys.argv[1:] or SOURCES:
        for row in ptxas_report(source):
            print(f"{source}: {row['kernel']:36s} registers {row['registers']:3d}  "
                  f"spill stores {row['spill_stores']:4d} B  loads {row['spill_loads']:4d} B")
