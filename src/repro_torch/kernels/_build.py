"""Compile the CUDA sources under ``csrc/`` with nvcc and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by hand
(``nvcc -shared``, no PyTorch headers, which keeps a build to seconds) into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout, where
the hash covers the source, every shared header ``csrc/*.cuh`` and the
flags, so an edited source or header is rebuilt.
The build runs at first use; ``build(*names)`` starts one nvcc per source,
all together, and waits for them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's
    usual install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest = hashlib.sha256(digest.digest()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for every name not built yet, one nvcc
    process each, all started before any is awaited.  The compiler's
    report (registers, shared memory, spills) lands beside the library as
    ``.log``.  Returns {name: library path}; raises if a build fails."""
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)   # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiled on first use."""
    return ctypes.CDLL(str(build(name)[name]))
