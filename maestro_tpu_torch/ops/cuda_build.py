"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``.  All
sources are compiled in parallel (one ``nvcc`` process each) the first time
any kernel is asked for; nothing is built at import.  Libraries land in
``build/kernels-<hash>/`` at the checkout root, where the hash covers the
content of every file in ``csrc/``: an edited source rebuilds, an unchanged
one is reused.  A failed build raises with the compiler's output.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_info: dict[str, object] = {}  # seconds, directory, ptxas log of the last build


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        msg = "nvcc not found: the CUDA kernels cannot be built on this machine."
        raise RuntimeError(msg)
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def _build_all() -> Path:
    """Compile every source (in parallel) unless this content is built already."""
    out_dir = BUILD_ROOT / f"kernels-{_source_hash()}"
    sources = _sources()
    if all((out_dir / f"lib{src.stem}.so").exists() for src in sources):
        build_info.setdefault("seconds", 0.0)
        build_info["directory"] = str(out_dir)
        return out_dir
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    procs = []
    for src in sources:
        # compile to a private name, rename when complete: a build that was
        # cut off never leaves a half-written library under the final name
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs, failed = [], []
    for src, tmp, proc in procs:
        output, _ = proc.communicate()
        logs.append(f"== {src.name}\n{output}")
        if proc.returncode != 0:
            failed.append(src.name)
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(out_dir / f"lib{src.stem}.so")
    build_info["seconds"] = time.perf_counter() - start
    build_info["directory"] = str(out_dir)
    build_info["log"] = "\n".join(logs)
    if failed:
        msg = f"nvcc failed for {failed}:\n" + "\n".join(logs)
        raise RuntimeError(msg)
    return out_dir


def load_library(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out_dir = _build_all()
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            _libs[name] = lib
        return lib
