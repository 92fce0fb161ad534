"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` alone (no PyTorch headers, so a build takes seconds) into a
``.so`` that :mod:`ctypes` loads.  Builds happen at first use, on the
machine with the card, into ``build/kernels/`` at the repository root
(``.gitignore`` lists ``build/``).  A library's file name carries a hash
of its source, the ``*.cuh`` headers beside it and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.

:func:`build` starts one ``nvcc`` per missing source, all at once, and
waits for them together; :func:`load` builds (if needed) and opens one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "library_path", "build", "load",
           "build_log", "sass"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[Path, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives (hash-named over the
    source, the ``*.cuh`` headers beside it and the flags)."""
    source = Path(source)
    headers = sorted(source.parent.glob("*.cuh"))
    h = hashlib.sha256(b"".join(p.read_bytes() for p in [source, *headers])
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{source.stem}-{h}.so"


def build_log(source: Path) -> str:
    """nvcc's output (ptxas register / spill report) for ``source``'s
    current build, or '' when it has not been built here."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass(source: Path) -> str:
    """The SASS of ``source``'s current build, as the toolkit's
    ``cuobjdump -sass`` prints it (the instructions that really run)."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(library_path(source))],
                          check=True, capture_output=True, text=True,
                          timeout=120).stdout


def build(sources: list[Path]) -> dict[Path, Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together.  Returns ``{source: library}``; raises with
    nvcc's output if any compile fails."""
    out = {Path(s): library_path(Path(s)) for s in sources}
    todo = {s: lib for s, lib in out.items() if not lib.exists()}
    if not todo:
        return out
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for src, lib in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
        os.close(fd)
        p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        procs.append((src, lib, tmp, p))
    errors = []
    for src, lib, tmp, p in procs:
        log, _ = p.communicate()
        lib.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {src} (exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(source: Path) -> ctypes.CDLL:
    """The loaded library for ``source``, building it first if needed."""
    lib = build([Path(source)])[Path(source)]
    if lib not in _loaded:
        _loaded[lib] = ctypes.CDLL(str(lib))
    return _loaded[lib]
