"""Serving artifacts: the port's samplers exported with ``torch.export``.

Counterpart of ``image_restoration_sde_tpu/exporting.py``.  An artifact is
one file that restores images without the model code or the config system:
the networks' weights and the schedule tables are baked into exported
programs, and :func:`load_artifact` returns ``call(lq, seed) -> restored``.

File layout, as the JAX package's: the magic ``IRSDET1\\n`` (the JAX
package's is ``IRSDEX1\\n``, so neither loader mistakes the other's file),
an 8-byte big-endian header length, the UTF-8 JSON header, then the payload:
the programs, each a ``torch.export.save`` archive, back to back, at the
``[offset, length]`` the header's ``programs`` gives.  :func:`read_header`
reads the header alone and loads no program.

The programs are STEP programs: one per network call, not one for the whole
chain (``torch.export`` has no public loop construct; unrolling the chain
would multiply the trace time and the program by T, and the card would run
the same kernels).  Restoration and denoising artifacts hold ``step``, the
reverse step ``(x_t, mu, t, noise) -> x_{t-1}`` (``(x_t, mu, t)`` for the
ODE, ``(x_t, t)`` for denoising; ``t`` the int32 (b,) timestep the net
takes); latent artifacts also ``encode`` (``lq -> (latent, skips)``) and
``decode`` (``(latent, skips) -> image``).  The loader runs the chain
around them and draws the noise on the device, as the eager samplers do
(``torch.export`` cannot trace a ``torch.Generator``): from one generator
for a scalar seed, from one per sample for a (b,) seed vector, in the eager
samplers' order, so a loaded call equals the eager sampler's with the same
generators.

With ``kernels=True`` (the default) the programs call the ``irsde::``
operators, whose CUDA implementations launch the port's kernels and whose
CPU implementations are the plain versions, so one artifact runs on either
device; ``kernels=False`` traces the nets' plain versions (an artifact that
needs only torch's own operators).  ``batch=None`` exports a symbolic batch
dimension.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import ops  # noqa: F401 -- registers the irsde:: operators the programs call
from .sampling import cast_net_params, check_mode
from .sde import DenoisingSDE, IRSDE, rng, samplers
from .sde.irsde import noisy_start
from .sde.rng import normal_like

MAGIC = b"IRSDET1\n"
OP_NAMESPACE = "irsde"
# the symbolic batch's range and the batch it is traced at (1 would
# specialise the dimension)
MAX_BATCH = 1024
TRACE_BATCH = 2


# ----------------------------------------------------------- artifact file
def pack_artifact(header: dict, payload: bytes) -> bytes:
    head = json.dumps(header, sort_keys=True).encode("utf-8")
    return MAGIC + struct.pack(">Q", len(head)) + head + payload


def unpack_artifact(data: bytes) -> Tuple[dict, bytes]:
    if data[: len(MAGIC)] != MAGIC:
        raise ValueError("not an IRSDE torch.export artifact (bad magic)")
    off = len(MAGIC)
    (hlen,) = struct.unpack(">Q", data[off : off + 8])
    off += 8
    header = json.loads(data[off : off + hlen].decode("utf-8"))
    return header, data[off + hlen :]


def read_header(path: str) -> dict:
    """The header alone: no program is read or loaded."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC) + 8)
        if head[: len(MAGIC)] != MAGIC:
            raise ValueError("not an IRSDE torch.export artifact (bad magic)")
        (hlen,) = struct.unpack(">Q", head[len(MAGIC) :])
        return json.loads(f.read(hlen).decode("utf-8"))


# ------------------------------------------------------------ step modules
class RestorationStep(nn.Module):
    """One IR-SDE reverse step of ``mode`` through the score net:
    ``(x_t, mu, t, noise) -> x_{t-1}`` (no ``noise`` for the ODE), the
    eager samplers' step (``samplers.REVERSE_STEPS``) with the coefficients
    of each row's t.  ``cond``: values baked as per-sample constants, the
    net's fourth argument (the bokeh net's lens values)."""

    def __init__(self, sde: IRSDE, net: nn.Module, mode: str, cond: Optional[Sequence[float]] = None):
        super().__init__()
        self.sde, self.net, self.mode = sde, net, mode
        self.cond = None if cond is None else tuple(float(v) for v in cond)

    def _noise(self, x, mu, t):
        if self.cond is None:
            return self.net(x, mu, t)
        lens = tuple(torch.full((x.shape[0],), v, dtype=torch.float32, device=x.device) for v in self.cond)
        return self.net(x, mu, t, lens)

    def forward(self, x, mu, t, noise=None):
        return samplers.REVERSE_STEPS[self.mode](self.sde, self._noise, x, mu, t, noise)


class DenoisingStep(nn.Module):
    """One reverse-ODE step of the denoising SDE: ``(x_t, t) -> x_{t-1}``
    (``samplers.dsde_ode_step``)."""

    def __init__(self, sde: DenoisingSDE, net: nn.Module):
        super().__init__()
        self.sde, self.net = sde, net

    def forward(self, x, t):
        return samplers.dsde_ode_step(self.sde, lambda x_, t_: self.net(x_, None, t_), x, t)


class _Encode(nn.Module):
    def __init__(self, compressor):
        super().__init__()
        self.compressor = compressor

    def forward(self, lq):
        latent, hidden = self.compressor.encode(lq)
        return latent, list(hidden)


class _Decode(nn.Module):
    def __init__(self, compressor, size):
        super().__init__()
        self.compressor, self.size = compressor, tuple(size)

    def forward(self, latent, hidden):
        return self.compressor.decode(latent, hidden)[:, : self.size[0], : self.size[1], :]


# ------------------------------------------------------------------ export
def frozen_copy(net: nn.Module, cast_params=None, plain: bool = False) -> nn.Module:
    """A copy of ``net`` for export, in eval mode: with ``cast_params`` its
    parameters and buffers hold the values ``sampling.make_noise_fn``
    computes once per call (``sampling.cast_net_params``), so the program
    bakes what the eager sampler runs; with ``plain`` every module that
    holds a kernel takes its plain version."""
    net = copy.deepcopy(net).eval().requires_grad_(False)
    if plain:
        for m in net.modules():
            if hasattr(m, "plain"):
                m.plain = True
    if cast_params is not None:
        for name, value in cast_net_params(net, cast_params).items():
            owner, _, leaf = name.rpartition(".")
            module = net.get_submodule(owner)
            if leaf in module._parameters:
                module._parameters[leaf] = nn.Parameter(value, requires_grad=False)
            else:
                module._buffers[leaf] = value
    return net


def _batch_dims(batch: Optional[int]):
    if batch is None:
        return torch.export.Dim("batch", min=1, max=MAX_BATCH), TRACE_BATCH
    return None, int(batch)


def _export(module: nn.Module, args: tuple, dims) -> torch.export.ExportedProgram:
    with torch.no_grad():
        return torch.export.export(module, args, dynamic_shapes=dims)


def _dims_like(args, b):
    """dynamic_shapes marking axis 0 of every tensor in ``args`` (lists
    included) as the batch."""
    if b is None:
        return None
    return tuple([{0: b} for _ in a] if isinstance(a, (list, tuple)) else {0: b} for a in args)


def _custom_ops(programs) -> list:
    names = set()
    for ep in programs.values():
        for node in ep.graph.nodes:
            if node.op == "call_function" and getattr(node.target, "namespace", None) == OP_NAMESPACE:
                names.add(f"{OP_NAMESPACE}::{node.target._opname}")
    return sorted(names)


def _spec(args, outs) -> dict:
    def desc(t):
        if isinstance(t, (list, tuple)):
            return [desc(a) for a in t]
        return {"shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", "")}

    return {"inputs": [desc(a) for a in args], "outputs": desc(outs)}


def _package(programs: dict, specs: dict, info: dict, kernels: bool, batch: Optional[int], meta) -> bytes:
    payload, where = b"", {}
    for name, ep in programs.items():
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        where[name] = [len(payload), len(buf.getvalue())]
        payload += buf.getvalue()
    header = {
        "format": "torch.export",
        "program": "step",
        "programs": where,
        "specs": specs,
        "devices": ["cpu", "cuda"],
        "kernels": bool(kernels),
        "custom_ops": _custom_ops(programs),
        "torch_version": torch.__version__,
        "batch": "symbolic" if batch is None else int(batch),
        **info,
        **(meta or {}),
    }
    return pack_artifact(header, payload)


def _n_params(*nets) -> int:
    return int(sum(p.numel() for net in nets for p in net.parameters()))


def _example(shape, device):
    """A seeded example input for the trace."""
    return torch.rand(shape, generator=rng.generator(0, "cpu")).to(device)


def _step_program(step: nn.Module, x: torch.Tensor, stochastic: bool, b):
    """Export ``step`` at the state ``x`` (and ``mu``, a copy: one tensor
    passed twice would be traced as one input); returns (program, spec)."""
    t = torch.full((x.shape[0],), 1, dtype=torch.int32, device=x.device)
    args = (x, x.clone(), t, torch.zeros_like(x)) if stochastic else (x, x.clone(), t)
    ep = _export(step, args, _dims_like(args, b))
    return ep, _spec(args, x)


def export_restoration_sampler(
    sde: IRSDE,
    net: nn.Module,  # net(xt, cond, tvec) -> noise, NHWC
    size: Tuple[int, int],
    *,
    mode: str = "posterior",
    steps: Optional[int] = None,
    channels: int = 3,
    batch: Optional[int] = None,  # None => symbolic batch dim
    kernels: bool = True,
    cast_params=None,
    per_sample_seed: bool = False,
    meta: Optional[dict] = None,
) -> bytes:
    """An artifact of ``make_restoration_sampler(sde, net, mode, steps,
    cast_params=cast_params)``: ``call(lq, seed)`` restores an NHWC float32
    batch of ``size`` with ``channels`` channels.  ``per_sample_seed``:
    ``call(lq, seeds)`` takes a (b,) seed vector, and row i depends only on
    seeds[i] (one generator per sample).  ``cast_params`` casts the
    parameters before the export, as the eager sampler casts them once per
    call."""
    check_mode(mode)
    device = sde.dt.device
    b, trace_b = _batch_dims(batch)
    H, W = size
    step = RestorationStep(sde, frozen_copy(net, cast_params, plain=not kernels), mode)
    x = _example((trace_b, H, W, channels), device)
    ep, spec = _step_program(step, x, mode != "ode", b)
    info = {
        "kind": "restoration_sampler",
        "mode": mode,
        "steps": int(steps if steps is not None else sde.T),
        "size": [H, W],
        "channels": channels,
        "seed": "per_sample" if per_sample_seed else "scalar",
        "n_params": _n_params(net),
        "max_sigma": float(sde.max_sigma),
    }
    return _package({"step": ep}, {"step": spec}, info, kernels, batch, meta)


def export_denoising_sampler(
    sde: DenoisingSDE,
    net: nn.Module,  # net(x, None, tvec) -> noise, NHWC
    size: Tuple[int, int],
    sigma: float,
    *,
    channels: int = 3,
    batch: Optional[int] = None,
    kernels: bool = True,
    cast_params=None,
    meta: Optional[dict] = None,
) -> bytes:
    """An artifact of ``make_denoising_sampler(sde, net, sigma,
    cast_params)``: the reverse ODE from ``sde.get_optimal_timestep(sigma)``.
    ``call(noisy, seed)`` ignores the seed (a deterministic chain), so every
    artifact kind shares the ``call(lq, seed)`` interface."""
    device = sde.dt.device
    b, trace_b = _batch_dims(batch)
    H, W = size
    step = DenoisingStep(sde, frozen_copy(net, cast_params, plain=not kernels))
    x = _example((trace_b, H, W, channels), device)
    t = torch.full((trace_b,), 1, dtype=torch.int32, device=device)
    ep = _export(step, (x, t), _dims_like((x, t), b))
    info = {
        "kind": "denoising_sampler",
        "sigma": float(sigma),
        "steps": int(sde.get_optimal_timestep(sigma)),
        "size": [H, W],
        "channels": channels,
        "seed": "ignored",
        "n_params": _n_params(net),
    }
    return _package({"step": ep}, {"step": _spec((x, t), x)}, info, kernels, batch, meta)


def export_latent_sampler(
    sde: IRSDE,
    net: nn.Module,  # net(xt, cond, tvec[, lens]) -> noise, NHWC latents
    compressor: nn.Module,  # encode(x) -> (latent, skips); decode(latent, skips)
    size: Tuple[int, int],
    *,
    mode: str = "sde",
    steps: Optional[int] = None,
    batch: Optional[int] = None,
    kernels: bool = True,
    cast_params=None,
    cond: Optional[Sequence[float]] = None,
    per_sample_seed: bool = False,
    meta: Optional[dict] = None,
) -> bytes:
    """An artifact of ``training.make_latent_sampler(sde, net, compressor,
    mode, steps, cast_params=cast_params)``: ``encode``, the latent
    ``step`` and ``decode`` programs; ``cast_params`` casts the score net's
    parameters only, as the eager sampler does.  ``cond``: the bokeh net's
    lens values (src, tgt, disparity), baked as per-sample constants."""
    check_mode(mode)
    device = sde.dt.device
    b, trace_b = _batch_dims(batch)
    H, W = size
    comp = frozen_copy(compressor, plain=not kernels)
    lq = _example((trace_b, H, W, 3), device)
    encode, decode = _Encode(comp), _Decode(comp, size)
    enc = _export(encode, (lq,), _dims_like((lq,), b))
    with torch.no_grad():
        latent, hidden = encode(lq)
    dec = _export(decode, (latent, hidden), _dims_like((latent, hidden), b))
    step = RestorationStep(sde, frozen_copy(net, cast_params, plain=not kernels), mode, cond)
    ep, spec = _step_program(step, latent, mode != "ode", b)
    info = {
        "kind": "latent_sampler",
        "mode": mode,
        "steps": int(steps if steps is not None else sde.T),
        "size": [H, W],
        "channels": 3,
        "seed": "per_sample" if per_sample_seed else "scalar",
        "n_params": _n_params(net, compressor),
        "max_sigma": float(sde.max_sigma),
        **({"cond": [float(v) for v in cond]} if cond is not None else {}),
    }
    specs = {"encode": _spec((lq,), (latent, hidden)), "step": spec,
             "decode": _spec((latent, hidden), lq)}
    return _package({"encode": enc, "step": ep, "decode": dec}, specs, info, kernels, batch, meta)


# -------------------------------------------------------------------- load
class LoadedSampler:
    """``call(lq, seed) -> restored``: the artifact's chain on its device.

    ``lq`` is an NHWC float32 batch (a tensor or an array) at the header's
    size and channels, at its batch where that is fixed; ``seed`` an int,
    or for a per-sample-seed artifact one int per row; the result is a
    float32 tensor on the device.  :meth:`with_noise` runs the chain on
    given noise instead of drawing it."""

    def __init__(self, header: dict, programs: dict, device: torch.device):
        self.header, self.programs, self.device = header, programs, device
        self.kind = header["kind"]
        self.steps = int(header["steps"])
        self.stochastic = self.kind != "denoising_sampler" and header.get("mode") != "ode"
        self.max_sigma = (torch.tensor(header["max_sigma"], dtype=torch.float32, device=device)
                          if "max_sigma" in header else None)

    def _input(self, lq) -> torch.Tensor:
        return self._check(lq).to(self.device)

    def _check(self, lq) -> torch.Tensor:
        lq = torch.as_tensor(lq, dtype=torch.float32)
        H, W = self.header["size"]
        want = (H, W, self.header.get("channels", 3))
        if lq.dim() != 4 or tuple(lq.shape[1:]) != want:
            raise ValueError(f"lq must be (b, {H}, {W}, {want[2]}), got {tuple(lq.shape)}")
        fixed = self.header["batch"]
        if fixed != "symbolic" and lq.shape[0] != fixed:
            raise ValueError(f"this artifact takes a batch of {fixed}, got {lq.shape[0]}")
        return lq

    def _generators(self, seed, batch: int):
        """The chain's generator(s) for ``seed``: one, or one per sample."""
        kind = self.header["seed"]
        if kind == "ignored":
            return None
        if kind == "per_sample":
            seeds = [int(s) for s in torch.as_tensor(seed).reshape(-1).tolist()]
            if len(seeds) != batch:
                raise ValueError(f"{len(seeds)} seeds for a batch of {batch}")
            return rng.generators_for_seeds(seeds, self.device)
        return rng.generator(int(seed), self.device)

    def __call__(self, lq, seed=0) -> torch.Tensor:
        lq = self._input(lq)
        return self.run(lq, gen=self._generators(seed, lq.shape[0]))

    def with_noise(self, lq, noise) -> torch.Tensor:
        """The chain with ``noise[0]`` as the initial state's noise and
        ``noise[i]`` as step i's (t = T first): ``1 + steps`` arrays of the
        state's shape (only the first for the ODE, none for denoising)."""
        lq = self._input(lq)
        if self.kind == "denoising_sampler":
            return self.run(lq)
        noise = torch.as_tensor(np.asarray(noise), dtype=torch.float32).to(self.device)
        return self.run(lq, noise=noise)

    def run(self, lq: torch.Tensor, gen=None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The chain on ``lq`` through the eager samplers' loops
        (``samplers.loop_with_noise``), its noise drawn from ``gen`` in
        their order (the initial state's first, then t = T..1), or taken
        from ``noise`` (see :meth:`with_noise`)."""
        step = self.programs["step"]
        b, ts = lq.shape[0], range(self.steps, 0, -1)
        with torch.inference_mode():
            def tv(t):
                return samplers.tvec(b, t, self.device)

            if self.kind == "denoising_sampler":
                return samplers.loop(lambda x, t: step(x, tv(t)), lq, ts)
            hidden = None
            if self.kind == "latent_sampler":
                mu, hidden = self.programs["encode"](lq)
            else:
                mu = lq
            x = noisy_start(mu, normal_like(gen, mu) if noise is None else noise[0], self.max_sigma)
            if self.stochastic:
                x = samplers.loop_with_noise(lambda x, t, z: step(x, mu, tv(t), z), x, self.steps, gen,
                                             None if noise is None else noise[1:])
            else:
                x = samplers.loop(lambda x, t: step(x, mu, tv(t)), x, ts)
            if hidden is not None:
                x = self.programs["decode"](x, hidden)
            return x


def on_device(device: torch.device):
    """The context a thread runs a device's work in: that card made the
    thread's current CUDA device (the kernels' launchers and the CUDA
    runtime act on the current device), nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class DataParallelSampler:
    """``call(lq, seeds) -> restored`` over several devices: the batch split
    into contiguous row blocks, one a device (the first devices take one
    row more where it does not divide; a device with no row sits out),
    each block's per-sample seeds with its rows, the blocks run at once
    (one thread a device, each under :func:`on_device`), the rows put back
    in order on the first device.  A row's output depends on its own seed
    alone, so a call is the one-device call's row for row where the device
    computes a row alike at any batch."""

    def __init__(self, samplers: Sequence[LoadedSampler]):
        self.samplers = list(samplers)
        self.header = self.samplers[0].header
        self.devices = [s.device for s in self.samplers]
        self.device = self.devices[0]

    def blocks(self, batch: int) -> list:
        """``(sampler, rows)`` of each device that takes rows of ``batch``."""
        n = len(self.samplers)
        sizes = [batch // n + (i < batch % n) for i in range(n)]
        starts = np.cumsum([0] + sizes)
        return [(s, slice(int(a), int(a) + k)) for s, a, k in zip(self.samplers, starts, sizes) if k]

    def __call__(self, lq, seed=0) -> torch.Tensor:
        lq = self.samplers[0]._check(lq)
        seeds = None
        if self.header["seed"] == "per_sample":
            seeds = [int(v) for v in torch.as_tensor(seed).reshape(-1).tolist()]
            if len(seeds) != lq.shape[0]:
                raise ValueError(f"{len(seeds)} seeds for a batch of {lq.shape[0]}")

        def run(sampler, rows):
            with on_device(sampler.device):
                x = lq[rows].to(sampler.device)
                gen = sampler._generators(seed if seeds is None else seeds[rows], x.shape[0])
                return sampler.run(x, gen=gen).to(self.device)

        blocks = self.blocks(lq.shape[0])
        with ThreadPoolExecutor(len(blocks)) as pool:
            futures = [pool.submit(run, s, rows) for s, rows in blocks]
            return torch.cat([f.result() for f in futures])


def load_artifact(data_or_path, device="cuda", devices: Optional[Sequence] = None) -> tuple:
    """``(call, header)``: the artifact's programs loaded onto ``device``
    (the card by default; it raises where there is none).  ``devices``
    (e.g. ``["cuda:0", "cuda:1"]``): one copy of the programs on each, and
    ``call`` a :class:`DataParallelSampler` over them; more than one device
    takes a symbolic batch and no single scalar seed (N blocks cannot draw
    one generator's noise)."""
    from torch.export.passes import move_to_device_pass

    from .runners import resolve_device

    if isinstance(data_or_path, (bytes, bytearray)):
        data = bytes(data_or_path)
    else:
        with open(data_or_path, "rb") as f:
            data = f.read()
    header, payload = unpack_artifact(data)
    targets = [resolve_device(str(d)) for d in (devices if devices else [device])]
    if len(targets) > 1 and header["batch"] != "symbolic":
        raise ValueError(f"a batch split over {len(targets)} devices needs a symbolic-batch artifact; this one takes "
                         f"a batch of {header['batch']}")
    if len(targets) > 1 and header["seed"] == "scalar":
        raise ValueError(f"a scalar seed draws one generator's noise for the whole batch, which {len(targets)} "
                         f"devices cannot split: export with per-sample seeds")
    # each program read once; the pass moves a program in place, so every
    # device but the last moves a copy
    eps = {name: torch.export.load(io.BytesIO(payload[off : off + n]))
           for name, (off, n) in header["programs"].items()}
    samplers = [LoadedSampler(header, {name: move_to_device_pass(ep if i == len(targets) - 1 else copy.deepcopy(ep),
                                                                 target).module()
                                       for name, ep in eps.items()}, target) for i, target in enumerate(targets)]
    if devices:
        return DataParallelSampler(samplers), header
    return samplers[0], header
