"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. Libraries go into ``csrc/build/``, named by a hash of the sources
and flags, so an edited source is rebuilt at its next first use and an
unchanged one is loaded as it is. All missing libraries build in parallel,
one ``nvcc`` each; ``build`` returns what the compiler reports (registers,
shared memory, spills). ``build`` also takes another source directory (a
copy of another version of ``csrc/``, to time it against this one), whose
libraries go into its own ``build/``.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA kernels of neural_admixture_tpu_torch need the "
        "CUDA toolkit on the machine with the card.")


def _lib_path(name: str, csrc: Path) -> Path:
    h = hashlib.sha256()
    for src in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return csrc / "build" / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=None, csrc: Path = CSRC) -> Dict[str, dict]:
    """Compile every kernel source of ``csrc`` (``names``, or all) whose
    library is missing, in parallel.

    Returns {name: {"path", "seconds", "log"}}; "log" is nvcc's output and
    "seconds" 0.0 for a library that was already built. Raises if nvcc
    fails."""
    csrc = Path(csrc)
    names = names or sorted(p.stem for p in csrc.glob("*.cu"))
    (csrc / "build").mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        path = _lib_path(name, csrc)
        out[name] = {"path": path, "seconds": 0.0, "log": ""}
        if path.exists():
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        out[name]["seconds"] = time.perf_counter() - t0
        out[name]["log"] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out[name]["path"])
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]["path"]))
        _LIBS[name] = lib
    return lib
