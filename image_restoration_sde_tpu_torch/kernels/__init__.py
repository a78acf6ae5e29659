"""Build, load and launch the package's hand-written CUDA kernels.

The sources in ``../csrc/*.cu`` compile with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``.  The build runs at the first
launch, never at import, into ``_build/<hash of sources and flags>/`` inside
the package (listed in ``.gitignore``), so a checkout builds everything it
runs from its own sources.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`Kernel` raises when that is not 0 and counts
the launches that went through.  Under a CUDA graph capture
(:func:`recording`, ``sde/captured.py``) a call records a node and launches
nothing: the :class:`Recording` counts it, and each replay of the graph adds
those counts to the kernels' ``launches`` (:meth:`Recording.replayed`).  A
call that another thread makes on the stream of a warm-up or capture under
way (the autograd engine's, running a train step's backward) counts as
that warm-up's or capture's (:func:`on_stream`).

Each public op of ``../ops`` is one operator of the ``irsde`` library
(:func:`define_op`): a CUDA implementation that launches the kernels, a CPU
implementation that is the plain version, a fake implementation that gives
the CUDA output's shape, dtype and strides (what ``torch.export`` traces
with), and its autograd.  Eager code and exported programs reach the kernels
through these operators alone.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libirsde_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple:
    """Compile the library if the current sources have none yet: one
    ``nvcc -c`` per source, all started together, then one link.

    Returns ``(path, seconds spent compiling)``; the compiler's register and
    shared-memory report goes to ``ptxas.log`` beside the library.
    """
    lib = library_path()
    if lib.is_file():
        return lib, 0.0
    lib.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = lib.parent / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for obj, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{out[-4000:]}")
    if not failed:
        tmp = lib.with_suffix(f".{tag}")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(o) for o, _ in jobs)],
                              capture_output=True, text=True)
        log.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
    seconds = time.perf_counter() - t0
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (lib.parent / "ptxas.log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)
    return lib, seconds


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = ctypes.CDLL(str(build()[0]))
    lib.irsde_error_string.argtypes = [ctypes.c_int]
    lib.irsde_error_string.restype = ctypes.c_char_p
    lib.irsde_la_ctx_workspace.argtypes = [ctypes.c_int] * 4
    lib.irsde_la_ctx_workspace.restype = ctypes.c_longlong
    lib.irsde_lin_attn_ctx_workspace.argtypes = [ctypes.c_int] * 4
    lib.irsde_lin_attn_ctx_workspace.restype = ctypes.c_longlong
    lib.irsde_naf_stack_workspace.argtypes = [ctypes.c_int] * 4
    lib.irsde_naf_stack_workspace.restype = ctypes.c_longlong
    lib.irsde_naf_stack_stamps.argtypes = [ctypes.c_int]
    lib.irsde_naf_stack_stamps.restype = ctypes.c_int
    return lib


class Kernel:
    """One C entry point of the library, with its launch count.

    ``launches`` goes up by one for each launch that the CUDA runtime
    accepted, and by a graph's recorded count of this kernel at each replay
    of that graph; a call made while this thread captures a graph adds
    nothing.  ``warmups`` counts, of ``launches``, those made while this
    thread warms a chain up before capturing it (:func:`warming_up`): a
    signature's first call, apart from the request.  ``source`` is the file
    in the repository,
    ``replaces`` the TPU kernel it ports (``file:line``).  Threads that
    drive several cards (``exporting.DataParallelSampler``) launch one at a
    time: ctypes releases the interpreter lock during the call, and the
    launchers keep host-side caches (K4's tensor maps).
    """

    def __init__(self, symbol: str, argtypes: list, source: str, replaces: str):
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.warmups = 0

    @functools.cached_property
    def _fn(self):
        fn = getattr(load_library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args) -> None:
        rec, warming = _state()
        with _LAUNCH_LOCK:
            err = self._fn(*args)
            if err == 0:
                if rec is not None:
                    rec.tally[self] = rec.tally.get(self, 0) + 1
                else:
                    self.launches += 1
                    self.warmups += warming
        if err != 0:
            msg = load_library().irsde_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")


_LAUNCH_LOCK = threading.Lock()


class _Thread(threading.local):
    recording = None  # the Recording of this thread's capture under way
    warming = False  # this thread warms a chain up before capturing it


_THREAD = _Thread()
# CUDA stream -> (Recording or None, warming) of a warm-up or capture under
# way on it (:func:`on_stream`)
_ON_STREAM = {}


def _state() -> tuple:
    """(the Recording, whether warming up) that a launch from this thread
    counts under: its own, else that of a warm-up or capture on the stream
    it launches on (the autograd engine runs a captured step's backward,
    and any forward recomputed there, on threads of its own)."""
    rec, warming = _THREAD.recording, _THREAD.warming
    if rec is None and not warming and _ON_STREAM:
        rec, warming = _ON_STREAM.get(torch.cuda.current_stream().cuda_stream, (None, False))
    return rec, warming


@contextlib.contextmanager
def on_stream(stream):
    """The block runs this thread's warm-up or capture (:func:`warming_up`,
    :func:`recording`) on ``stream``: launches other threads put on that
    stream meanwhile count as this thread's."""
    key = stream.cuda_stream
    _ON_STREAM[key] = (_THREAD.recording, _THREAD.warming)
    try:
        yield
    finally:
        _ON_STREAM.pop(key, None)


class Recording:
    """What one graph capture recorded of the kernels: ``tally`` (kernel ->
    its nodes in the graph) and ``held``, the tensors outside the graph's
    memory pool that its nodes read (a K3 pointer table, SCAM's resize
    tables), which the graph owns with it (:func:`hold`)."""

    def __init__(self):
        self.tally = {}
        self.held = []

    def replayed(self) -> None:
        """Count one replay of the graph: each kernel's recorded nodes."""
        with _LAUNCH_LOCK:
            for kernel, n in self.tally.items():
                kernel.launches += n


@contextlib.contextmanager
def recording():
    """The block captures a CUDA graph on this thread: its kernel calls
    record nodes into the yielded :class:`Recording` and count no launch."""
    rec, outer = Recording(), _THREAD.recording
    _THREAD.recording = rec
    try:
        yield rec
    finally:
        _THREAD.recording = outer


@contextlib.contextmanager
def warming_up():
    """The block warms a chain up before its capture: its launches are
    counted, and also in each kernel's ``warmups``."""
    outer, _THREAD.warming = _THREAD.warming, True
    try:
        yield
    finally:
        _THREAD.warming = outer


def capturing() -> bool:
    """Whether this thread is capturing a graph (inside :func:`recording`,
    or on the stream of one, :func:`on_stream`)."""
    return _state()[0] is not None


def hold(*tensors) -> None:
    """Make the graph this thread captures own ``tensors``, which its
    nodes read by address: nothing while no capture is under way."""
    rec = _state()[0]
    if rec is not None:
        rec.held.extend(tensors)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def current_stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


LIBRARY = torch.library.Library("irsde", "DEF")


def define_op(schema: str, *, cpu, cuda, fake, backward, setup_context, flops) -> torch._ops.OpOverload:
    """Define ``irsde::<schema>`` with its CPU, CUDA, fake and autograd
    implementations and its FLOP count; returns the operator's default
    overload.  There is no implementation for any other device: a tensor
    there raises.

    ``flops(*input shapes, out_shape=...)`` is the work of one call
    (``torch.utils.flop_counter.register_flop_formula``): what
    ``FlopCounterMode`` counts for the operator, whose kernel it cannot see
    into; the same arithmetic as ``chip_smoke.py``'s bounds."""
    from torch.utils.flop_counter import register_flop_formula

    name = schema.split("(", 1)[0]
    LIBRARY.define(schema)
    LIBRARY.impl(name, cpu, "CPU")
    LIBRARY.impl(name, cuda, "CUDA")
    qualname = f"irsde::{name}"
    torch.library.register_fake(qualname, fake, lib=LIBRARY)
    torch.library.register_autograd(qualname, backward, setup_context=setup_context, lib=LIBRARY)
    packet = getattr(torch.ops.irsde, name)
    register_flop_formula(packet)(flops)
    return packet.default


def plain_grads(plain, saved, grad, *args) -> tuple:
    """The gradients of ``plain(*saved, *args)`` with respect to the saved
    tensors for the output cotangent ``grad``: the backward of an operator
    whose kernel has none of its own is the autograd of its plain version
    on the saved inputs."""
    inputs = [t.detach().requires_grad_() for t in saved]
    with torch.enable_grad():
        out = plain(*inputs, *args)
    return torch.autograd.grad(out, inputs, grad)


# C dtype codes shared with csrc/common.cuh
DTYPE_F32 = 0
DTYPE_BF16 = 1


def dtype_code(dtype) -> int:
    if dtype == torch.float32:
        return DTYPE_F32
    if dtype == torch.bfloat16:
        return DTYPE_BF16
    raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}")
