"""Build and load the port's hand-written CUDA kernels.

Each kernel package keeps its sources under ``csrc/``.  On first use, one
``nvcc`` per source compiles a shared library with a plain C interface for
``sm_90a`` (Hopper) into ``build/repro_torch_kernels/`` at the repository
root; the file name carries a hash of the source, every header (``*.cuh``)
under ``kernels/`` and the flags, so an edited source or header is rebuilt
and a stale library is never loaded.  Kernels that share a source (K2a
and K2b, K4 and K5) share one library, built once.  A source with
``units`` > 1 is compiled as that many translation units, each with
``-DREPRO_UNITS=n -DREPRO_UNIT=u`` (``common.cuh``'s ``RT_UNIT``: unit u
holds a share of the source's template variants, unit 0 the C interface),
into objects that one more ``nvcc`` links into the same library; the
unit count is part of the hash.  ``build`` starts every missing compile
at once, links a library as soon as its units are done, and times each
process to its own exit.  The libraries are
loaded with ``ctypes``: pointers and the CUDA stream go in as
``c_void_p``, every launcher returns ``cudaGetLastError()`` and ``launch``
raises when that is not 0.

Nothing here runs when the package is imported: the build happens when a
CUDA tensor first reaches a kernel, so the port imports on a machine with
no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
# a unit's compile: the same flags, without linking
UNIT_FLAGS = [f for f in NVCC_FLAGS if f != "-shared"]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "repro_torch are built from source on first use")


class Kernel:
    """One hand-written CUDA kernel: its source, the TPU kernel it replaces,
    its loaded library and its launch count.

    ``launches`` is a plain int that ``launch`` raises by one for every
    kernel launch and nothing else touches, so a run can show that its main
    path really went through the kernel; ``launches_bwd`` counts the subset
    launched by a backward pass (K3's backward products), ``launches_tc``
    the subset that went to a tensor-core variant (K1, K2a, K2b, K3, K4,
    K5), ``launches_split`` the subset that cut its work across more than
    one block per output row (K6's page splits)."""

    def __init__(self, name: str, source: str, replaces: str,
                 functions: Dict[str, Sequence], units: int = 1):
        self.name = name
        self.source = KERNELS_DIR / source
        self.units = int(units)
        self.replaces = replaces
        self.functions = dict(functions)     # C symbol -> ctypes argtypes
        self.launches = 0
        self.launches_bwd = 0
        self.launches_tc = 0
        self.launches_split = 0
        self._lib: Optional[ctypes.CDLL] = None

    def reset(self) -> None:
        """Zero the launch counters."""
        self.launches = 0
        self.launches_bwd = 0
        self.launches_tc = 0
        self.launches_split = 0

    # -- build ---------------------------------------------------------------
    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in (self.source, *sorted(KERNELS_DIR.rglob("*.cuh"))):
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        h.update(f"units={self.units}".encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def commands(self, out: Path) -> Tuple[List[List[str]],
                                           Optional[List[str]]]:
        """(the compiles, run in parallel; the link that joins their
        objects, or None) that write the library ``out``."""
        nvcc, inc = nvcc_path(), f"-I{KERNELS_DIR}"
        if self.units == 1:
            return [[nvcc, *NVCC_FLAGS, inc, "-o", str(out),
                     str(self.source)]], None
        objs = [f"{out}.u{u}.o" for u in range(self.units)]
        return ([[nvcc, *UNIT_FLAGS, "-c", f"-DREPRO_UNITS={self.units}",
                  f"-DREPRO_UNIT={u}", inc, "-o", obj, str(self.source)]
                 for u, obj in enumerate(objs)],
                [nvcc, *NVCC_FLAGS, "-o", str(out), *objs])

    def relpath(self) -> str:
        return str(self.source.relative_to(REPO_ROOT))

    # -- load / launch ---------------------------------------------------------
    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            path = self.library_path()
            if not path.exists():
                build([self])
            lib = ctypes.CDLL(str(path))
            for sym, argtypes in self.functions.items():
                fn = getattr(lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, symbol: str, *args, bwd: bool = False,
               tc: bool = False, split: bool = False) -> None:
        """Call one C launcher on the current stream and raise if the launch
        was refused (``cudaGetLastError`` != 0); ``bwd`` / ``tc`` / ``split``
        count it as a backward / tensor-core / split launch too."""
        fn = getattr(self.lib(), symbol)
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(
                f"{self.name}: {symbol} failed to launch (cudaError {err})")
        self.launches += 1
        if bwd:
            self.launches_bwd += 1
        if tc:
            self.launches_tc += 1
        if split:
            self.launches_split += 1


def build(kernels: Iterable[Kernel]) -> Dict[str, float]:
    """Compile every kernel whose library is missing: every compile of
    every source at once, each library linked as soon as its units are
    done.  Returns {source stem: seconds from the start to its library},
    and for a source of several units {"stem.uN": seconds of unit N's
    compile} too, each process timed to its own exit.  Raises with the
    compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs, seen = [], set()
    t0 = time.perf_counter()
    for k in kernels:
        out = k.library_path()
        if out.exists() or out in seen:
            continue
        seen.add(out)
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        compiles, link = k.commands(tmp)
        running = [(f"{k.source.stem}.u{u}" if len(compiles) > 1
                    else None, _start(cmd)) for u, cmd in enumerate(compiles)]
        libs.append({"kernel": k, "out": out, "tmp": tmp, "link": link,
                     "running": running})
    took: Dict[str, float] = {}
    failed: List[str] = []
    while any(lib["running"] for lib in libs):
        time.sleep(0.02)
        for lib in libs:
            k, still = lib["kernel"], []
            for label, proc in lib["running"]:
                if proc.poll() is None:
                    still.append((label, proc))
                    continue
                now = time.perf_counter() - t0
                proc.log.seek(0)
                log = proc.log.read().decode(errors="replace")
                proc.log.close()
                if label is not None:
                    took[label] = now
                if proc.returncode != 0:
                    failed.append(f"--- {k.name} (nvcc exit "
                                  f"{proc.returncode})\n{log}")
                    lib["link"] = None
            lib["running"] = still
            if still or lib.get("done"):
                continue
            if lib["link"] is not None:
                # the units are done: link them (its exit ends the library)
                lib["running"] = [(None, _start(lib["link"]))]
                lib["link"] = None
                continue
            lib["done"] = True
            objs = [Path(f"{lib['tmp']}.u{u}.o") for u in range(k.units)]
            if k.units > 1:
                for o in objs:
                    o.unlink(missing_ok=True)
            if lib["tmp"].exists() and not any(
                    f.startswith(f"--- {k.name} ") for f in failed):
                took[k.source.stem] = time.perf_counter() - t0
                # atomic: a concurrent build never sees a half-written
                # library
                os.replace(lib["tmp"], lib["out"])
            else:
                lib["tmp"].unlink(missing_ok=True)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def _start(cmd: List[str]) -> subprocess.Popen:
    # the output goes to a file: a pipe nobody reads until the exit could
    # fill and stall the compiler
    log = tempfile.TemporaryFile()
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    proc.log = log
    return proc


def require(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """The checks every wrapper makes before handing a pointer to C."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dtype_code(dt: torch.dtype) -> int:
    """The element-type code the C launchers dispatch on."""
    return {torch.float32: 0, torch.bfloat16: 1}[dt]
