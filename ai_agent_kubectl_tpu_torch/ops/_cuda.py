"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` into a
shared library with a plain C interface (``build/lib<name>-<hash>.so``
at the root of the checkout) and loaded with ``ctypes``. The file name
carries a hash of the source, of every header beside it
(``csrc/*.cuh``, which the sources include) and of the flags, so an
edited source or header rebuilds and an unchanged one loads at once.
Nothing is built when a module is imported: the CPU paths never reach
this file's functions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

#: every kernel source of the port, ``csrc/<name>.cu``.
SOURCES = ("ragged_attention", "flash_attention", "int4_matmul",
           "paged_attention")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source on first use")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where ``csrc/<name>.cu`` builds to: its hash covers the source,
    every ``csrc/*.cuh`` (name and bytes) and the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source that is not built yet, one ``nvcc``
    process per source, all started together. Returns seconds per
    source built (empty when everything was built already). The
    compiler's output (register and shared-memory use per kernel) is
    kept beside each library as ``<library>.log``. Raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    took: Dict[str, float] = {}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.monotonic() - t0
        out.with_name(out.name + ".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def split_plan(name: str, symbol: str, *shape: int) -> tuple:
    """``(splits, keys_per_split, ws_rows)`` from an attention kernel's
    plan entry point ``symbol`` (``int fn(int..., int*, int*, long
    long*)``) in ``csrc/<name>.cu``: the kernel's own rule, read from its
    library, so it builds the kernel first. Raises ValueError when the
    kernel takes no such shapes."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [ctypes.c_int] * len(shape) + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    splits, kps, rows = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    err = fn(*shape, ctypes.addressof(splits), ctypes.addressof(kps),
             ctypes.addressof(rows))
    if err != 0:
        raise ValueError(f"{symbol} takes no shapes {shape}")
    return splits.value, kps.value, rows.value


def split_workspaces(splits: int, rows: int, head_dim: int, device) -> tuple:
    """The f32 workspaces of a key split, ``ws_o`` [splits, rows,
    head_dim] and ``ws_ml`` [splits, rows, 2], as data pointers (0, 0
    without a split), with the tensors that keep them alive."""
    if splits <= 1:
        return 0, 0, ()
    import torch

    ws_o = torch.empty((splits, rows, head_dim), dtype=torch.float32,
                       device=device)
    ws_ml = torch.empty((splits, rows, 2), dtype=torch.float32,
                        device=device)
    return ws_o.data_ptr(), ws_ml.data_ptr(), (ws_o, ws_ml)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def launch_counters() -> dict:
    """Every kernel wrapper that counts its launches (``.launches``: one
    per kernel launch in this process), by name."""
    from .flash_attention import flash_attention_cached
    from .paged_attention import (paged_decode_attention,
                                  paged_decode_attention_pool,
                                  paged_decode_attention_pool_sharded)
    from .quant4 import qmatmul4
    from .ragged_attention import (ragged_attention_pool,
                                   ragged_attention_pool_sharded)

    return {f.__name__: f for f in (
        ragged_attention_pool, flash_attention_cached, paged_decode_attention,
        paged_decode_attention_pool, qmatmul4, ragged_attention_pool_sharded,
        paged_decode_attention_pool_sharded)}


def launch_counts() -> dict:
    """This process's launch count of every kernel wrapper, by name."""
    return {name: f.launches for name, f in launch_counters().items()}
