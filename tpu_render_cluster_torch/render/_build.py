"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes its own
shared library, ``csrc/build/lib<name>-<digest>.so``, at first use. The
digest covers the source, every ``csrc/*.cuh`` header it may include, and
the flags, so an edited kernel or shared header is rebuilt and a stale
library is never loaded. The build directory is listed in
``.gitignore``; nothing is built when this module is imported.

The TLAS kernels' packet (the reference's ``TRC_TLAS_BLOCK`` tier) is a
compile-time width (``mesh::kTlasPacket``, 256 by default): each of
``PACKET_SOURCES`` is also built at the other widths of ``PACKETS``, one
library a width (the variant ``<name>_p<width>``, the source compiled with
``-DTRC_PACKET=<width>``), each at its first use, so a run builds only the
widths it launches.

``python -m tpu_render_cluster_torch.render._build [CSRC]`` builds every
kernel of ``CSRC`` (default: this package's ``csrc/``) into ``CSRC/build``,
the packet kernels at every width, and prints what ptxas reports of each:
registers, stack, spills.
``python -m tpu_render_cluster_torch.render._build --compare OTHER`` builds
this package's kernels and those of the ``csrc/`` directory ``OTHER`` (for
example an older checkout's) with the same flags, and says for each kernel
of both whether ptxas reported the same, line for line (the anonymous
namespaces' per-file ids aside).

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3``, no ``--use_fast_math``
(the kernels keep IEEE sqrt, division, sin and cos for parity with the
plain versions), and ``--fmad=false``: the kernels write out the fused
multiply-adds the reference rounds with (``fmaf``, see ``render/fp32.py``),
and nvcc must fuse no others.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The sources whose kernels walk packets of the TLAS variants' width, the
# widths they are built at, and the default one (no define).
PACKET_SOURCES = ("trace_fused_mesh_tlas", "mesh_bounce_tlas", "mesh_entry_keys",
                  "pool_mesh_bounce_tlas")
PACKETS = (128, 256, 512, 1024)
DEFAULT_PACKET = 256
# (name) -> the nvcc/ptxas report of the build that made the library
# (registers, shared memory, spills), or "" when an earlier build was reused.
build_logs: dict[str, str] = {}

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """The kernel names: one per ``csrc/*.cu``."""
    return sorted(path.stem for path in CSRC_DIR.glob("*.cu"))


def variant(name: str, packet: int | None = None) -> str:
    """The library of kernel ``name`` built for the TLAS packet ``packet``:
    ``name`` itself at the default width (or None, or a kernel without a
    packet), else ``<name>_p<packet>``. Raises for a width no build takes."""
    if packet is None or packet == DEFAULT_PACKET or name not in PACKET_SOURCES:
        return name
    if packet not in PACKETS:
        raise ValueError(f"{name}: no build for a packet of {packet} lanes (one of {PACKETS})")
    return f"{name}_p{packet}"


def packet_variants() -> list[str]:
    """Every non-default width's library of the packet kernels."""
    return [variant(name, packet) for name in PACKET_SOURCES for packet in PACKETS
            if packet != DEFAULT_PACKET]


_VARIANTS = {variant(name, packet): (name, packet)
             for name in PACKET_SOURCES for packet in PACKETS}


def _source_of(name: str) -> tuple[str, list[str]]:
    """A library's source kernel and its extra nvcc flags (the packet
    define of a width variant)."""
    source, packet = _VARIANTS.get(name, (name, DEFAULT_PACKET))
    return source, [] if packet == DEFAULT_PACKET else [f"-DTRC_PACKET={packet}"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found is not None:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels are built from source at "
        "first use and need the CUDA toolkit."
    )


def library_path(name: str) -> Path:
    source, defines = _source_of(name)
    digest = hashlib.sha256((CSRC_DIR / f"{source}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    digest.update("\0".join((*NVCC_FLAGS, *defines)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str] | None = None,
          processes: list[subprocess.Popen] | None = None) -> dict[str, Path]:
    """Build the named kernels (default: all, at the default packet; a
    width variant by its ``variant`` name), one nvcc each, all at once.

    Libraries that already exist for the current source and flags are
    reused. Raises with nvcc's output if any build fails. Each nvcc runs in
    a process group of its own, ended (``end``) if the build is left by an
    exception; nvcc processes are also appended to ``processes`` when given,
    so that another thread can end them.
    """
    names = sources() if names is None else list(names)
    targets = {name: library_path(name) for name in names}
    pending = {name: path for name, path in targets.items() if not path.is_file()}
    for name in targets:
        build_logs.setdefault(name, "")
    if not pending:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    failures = []
    try:
        for name, path in pending.items():
            partial = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            source, defines = _source_of(name)
            command = [nvcc, *NVCC_FLAGS, *defines, "-o", str(partial),
                       str(CSRC_DIR / f"{source}.cu")]
            jobs[name] = (
                partial,
                subprocess.Popen(
                    command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                    process_group=0,
                ),
            )
            if processes is not None:
                processes.append(jobs[name][1])
        for name, (partial, process) in jobs.items():
            output, _ = process.communicate()
            build_logs[name] = output
            if process.returncode != 0:
                partial.unlink(missing_ok=True)
                failures.append(f"{name} (nvcc exit {process.returncode}):\n{output}")
            else:
                os.replace(partial, pending[name])
    finally:
        for partial, process in jobs.values():
            if process.returncode is None:
                end(process)
                process.wait()
                partial.unlink(missing_ok=True)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return targets


def end(process: subprocess.Popen) -> None:
    """Kill a ``build``'s nvcc process that still runs, with the compilers
    it started (its process group)."""
    if process.returncode is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(process.pid, signal.SIGKILL)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        library = _libraries.get(name)
        if library is None:
            library = ctypes.CDLL(str(build([name])[name]))
            _libraries[name] = library
        return library


def resource_lines(log: str) -> list[str]:
    """The lines of a ptxas report that give registers, stack and spills,
    each kernel's after the line naming it (a source may instantiate one
    template kernel several times)."""
    keep = ("registers", "spill", "Compiling entry function")
    return [line.strip() for line in log.splitlines() if any(word in line for word in keep)]


def comparable_report(log: str) -> list[str]:
    """``resource_lines`` with each anonymous namespace's per-file id (part
    of the kernels' mangled names) taken out."""
    return [re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", line) for line in resource_lines(log)]


def compare(other: Path) -> int:
    """Build this package's kernels and those of ``other``, each afresh into
    ``build/compare`` beside its sources (so ptxas reports on every one),
    and print, per kernel of both, whether ptxas reported the same."""
    global CSRC_DIR, BUILD_DIR
    reports = []
    for csrc in (CSRC_DIR, other.resolve()):
        CSRC_DIR, BUILD_DIR = csrc, csrc / "build" / "compare"
        shutil.rmtree(BUILD_DIR, ignore_errors=True)
        build_logs.clear()
        build()
        reports.append({name: comparable_report(log) for name, log in build_logs.items()})
    ours, theirs = reports
    for name in sorted(set(ours) | set(theirs)):
        if name not in ours or name not in theirs:
            print(f"  {name}: only in {'this package' if name in ours else other}")
        else:
            print(f"  {name}: ptxas reports {'equal' if ours[name] == theirs[name] else 'differ'}")
    return 0


def main(argv: list[str]) -> int:
    global CSRC_DIR, BUILD_DIR
    if argv[:1] == ["--compare"]:
        return compare(Path(argv[1]))
    if argv:
        CSRC_DIR = Path(argv[0]).resolve()
        BUILD_DIR = CSRC_DIR / "build"
    started = time.perf_counter()
    build(sources() + packet_variants())
    print(f"built {len(build_logs)} kernels of {CSRC_DIR} in {time.perf_counter() - started:.2f} s")
    for name, log in sorted(build_logs.items()):
        for line in resource_lines(log):
            print(f"  {name}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
