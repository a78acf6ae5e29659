"""Tensor parallelism: Megatron splits of a net's layers over the model
group of a mesh (``parallel/mesh.py``), their collectives, and the
conversion between a whole state dict and one rank's shard.

Counterpart of ``shape_based_tp_sharding`` and ``shard_tree`` of
``image_restoration_sde_tpu/parallel/mesh.py``.  There a shape rule marks
which leaves are sharded and GSPMD inserts the collectives; here each net
names its splits (``tensor_parallel_plan``: DiT, ConditionalUNet, the
NAFNet family, the compressor) and the split layers call the collectives
themselves:

- :class:`ColumnLinear`: this rank's output features (for a ``chunks``-way
  output such as ``[q; k; v]`` or adaLN's six modulations, its part of each
  chunk); the input enters through :func:`copy_to_model` (identity forward,
  all-reduce of the gradient backward); ``gather`` assembles the whole
  output after (:func:`gather_from_model`);
- :class:`RowLinear`: this rank's input features, the partial products
  summed by :func:`reduce_from_model` (all-reduce forward, identity
  backward), the bias added once after;
- :class:`RowConv2d`: a convolution whose input channels are split, its
  whole input scattered to this rank's channels first;
- :func:`assemble_params`: a split layer's tensors made whole where a
  module reads them itself rather than through the layer (a NAFNet level
  fused into kernel K3, which needs every channel of a block): stored as
  this rank's slices like any other split parameter, assembled in one
  all-reduce before the read; backward, this rank's slice of the whole
  gradient, which is the same on every rank (activations are whole).

Activations are whole and equal on every rank of a model group outside
the split layers, so every module between them (norms, the port's
kernels) runs at full width on each rank, and each replicated parameter
gets the whole gradient on each rank.  The only collectives are
``all_reduce`` (a gather is the all-reduce of a zero-filled whole buffer),
which NCCL and gloo take for CUDA tensors alike.  The split layers keep
the names of the layers they replace, so a state dict keeps the
reference's keys; :class:`Layout` converts between the whole tensors and
this rank's slices, for checkpoints, the optimizer's moments and the EMA.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

COLUMN, ROW = "column", "row"
# the nets with a ``tensor_parallel_plan`` (named in plan_of's refusal)
PLANNED = ("DiT", "ConditionalUNet", "ConditionalNAFNet", "StereoConditionalNAFNet", "BokehConditionalNAFNet",
           "UNet (the compressor)")
# the narrowest input a convolution is split at (the JAX rule's min_last,
# which it applies to the output axis)
MIN_ROW_CHANNELS = 64


@dataclass(frozen=True)
class Split:
    """How a net's plan splits one layer (a ``Linear`` or a ``Conv2d``).
    ``kind`` COLUMN (a Linear's output features) or ROW (its input
    features, a convolution's input channels); a column split's output is
    ``chunks`` equal blocks, each split over the ranks, and ``gather``
    assembles the whole output after it."""

    kind: str
    chunks: int = 1
    gather: bool = False


# ------------------------------------------------------------- collectives
def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.preserve_format)
    tdist.all_reduce(out, group=group)
    return out


def _slot(whole: torch.Tensor, dim: int, chunks: int, rank: int, size: int) -> torch.Tensor:
    """The view of ``whole`` that rank ``rank`` of ``size`` holds: its
    ``1 / size`` of each of the ``chunks`` equal blocks along ``dim``."""
    dim = dim % whole.dim()
    blocks = whole.unflatten(dim, (chunks, -1))
    part = blocks.shape[dim + 1] // size
    return blocks.narrow(dim + 1, rank * part, part)


def take_slice(whole: torch.Tensor, dim: int, chunks: int, rank: int, size: int) -> torch.Tensor:
    """This rank's slice of a whole tensor (a copy, contiguous)."""
    return _slot(whole, dim, chunks, rank, size).flatten(dim % whole.dim(), dim % whole.dim() + 1).contiguous()


def assemble_many(local, specs, rank: int, size: int, group) -> list:
    """The whole tensors from every rank's slices (``specs``: each one's
    (dim, chunks)) in one all-reduce: each rank writes its slices into one
    zero-filled buffer, a contiguous segment a whole tensor, and the model
    group sums the buffers (exact: every element is one slice's value plus
    zeros)."""
    shapes = []
    for t, (dim, _) in zip(local, specs):
        shape = list(t.shape)
        shape[dim % t.dim()] *= size
        shapes.append(shape)
    sizes = [math.prod(s) for s in shapes]
    flat = local[0].new_zeros(sum(sizes))
    wholes = [seg.view(s) for seg, s in zip(flat.split(sizes), shapes)]
    for whole, t, (dim, chunks) in zip(wholes, local, specs):
        _slot(whole, dim, chunks, rank, size).copy_(t.unflatten(dim % t.dim(), (chunks, -1)))
    tdist.all_reduce(flat, group=group)
    return wholes


def assemble(local: torch.Tensor, dim: int, chunks: int, rank: int, size: int, group) -> torch.Tensor:
    """The whole tensor from every rank's slice (:func:`assemble_many` of one)."""
    return assemble_many([local], [(dim, chunks)], rank, size, group)[0]


# each takes the mesh (parallel.mesh.Mesh) whose model group it runs over
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh.model_group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, chunks):
        ctx.mesh, ctx.dim, ctx.chunks = mesh, dim, chunks
        return assemble(x, dim, chunks, mesh.model_rank, mesh.model_size, mesh.model_group)

    @staticmethod
    def backward(ctx, grad):
        m = ctx.mesh
        return take_slice(grad, ctx.dim, ctx.chunks, m.model_rank, m.model_size), None, None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _slot(x, dim, 1, mesh.model_rank, mesh.model_size).flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, grad):
        m = ctx.mesh
        return assemble(grad, ctx.dim, 1, m.model_rank, m.model_size, m.model_group), None, None


class _AssembleParams(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, specs, *local):
        ctx.mesh, ctx.specs = mesh, specs
        return tuple(assemble_many(local, specs, mesh.model_rank, mesh.model_size, mesh.model_group))

    @staticmethod
    def backward(ctx, *grads):
        m = ctx.mesh
        return (None, None, *(None if g is None else take_slice(g, d, c, m.model_rank, m.model_size)
                              for g, (d, c) in zip(grads, ctx.specs)))


def copy_to_model(x, mesh):
    """Identity forward; the gradient summed over the model group."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh):
    """The sum over the model group forward; identity backward."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x, mesh, dim: int = -1, chunks: int = 1):
    """The whole tensor from each rank's slice along ``dim``; backward, this
    rank's slice of the gradient."""
    return _GatherFromModel.apply(x, mesh, dim, chunks)


def scatter_to_model(x, mesh, dim: int = 1):
    """This rank's slice of a whole tensor along ``dim``; backward, the
    whole gradient assembled from the ranks' slices."""
    return _ScatterToModel.apply(x, mesh, dim)


# ------------------------------------------------------------ split layers
def _param(t: torch.Tensor, like: nn.Parameter) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=like.requires_grad)


class ColumnLinear(nn.Module):
    """A ``Linear`` holding this rank's output features (its part of each of
    ``chunks`` blocks); parameters float32, cast to the input's dtype.
    Each split layer's ``splits``: ``layer_splits`` of its split."""

    def __init__(self, linear: nn.Linear, split: Split, mesh):
        super().__init__()
        self.mesh, self.chunks, self.gather = mesh, split.chunks, split.gather
        r, n = mesh.model_rank, mesh.model_size
        self.weight = _param(take_slice(linear.weight.detach(), 0, split.chunks, r, n), linear.weight)
        self.bias = None if linear.bias is None else \
            _param(take_slice(linear.bias.detach(), 0, split.chunks, r, n), linear.bias)
        self.splits = layer_splits(split, self.bias is not None)

    def forward(self, x):
        x = copy_to_model(x, self.mesh)
        y = F.linear(x, self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype))
        return gather_from_model(y, self.mesh, -1, self.chunks) if self.gather else y


class RowLinear(nn.Module):
    """A ``Linear`` holding this rank's input features; its input is this
    rank's slice (a column split's output), the bias added after the sum."""

    def __init__(self, linear: nn.Linear, split: Split, mesh):
        super().__init__()
        self.mesh = mesh
        self.weight = _param(take_slice(linear.weight.detach(), 1, 1, mesh.model_rank, mesh.model_size),
                             linear.weight)
        self.bias = None if linear.bias is None else _param(linear.bias.detach().clone(), linear.bias)
        self.splits = layer_splits(split, self.bias is not None)

    def forward(self, x):
        y = reduce_from_model(F.linear(x, self.weight.to(x.dtype)), self.mesh)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class RowConv2d(nn.Module):
    """A ``Conv2d`` holding this rank's input channels: the whole input
    scattered to them, the partial convolutions summed, the bias added
    after."""

    def __init__(self, conv: nn.Conv2d, split: Split, mesh):
        super().__init__()
        if conv.groups != 1:
            raise ValueError(f"tensor parallelism: a grouped convolution ({conv}) has no row split")
        self.mesh = mesh
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.weight = _param(take_slice(conv.weight.detach(), 1, 1, mesh.model_rank, mesh.model_size), conv.weight)
        self.bias = None if conv.bias is None else _param(conv.bias.detach().clone(), conv.bias)
        self.splits = layer_splits(split, self.bias is not None)

    def forward(self, x):
        x = scatter_to_model(x, self.mesh, 1)
        y = reduce_from_model(F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding, self.dilation),
                              self.mesh)
        return y if self.bias is None else y + self.bias.to(y.dtype)[None, :, None, None]


def assemble_params(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> dict:
    """``tensors`` (names under ``module`` -> the tensors in use, which
    ``torch.func.functional_call`` may have swapped in) with each one that
    a split layer holds assembled whole from the model group, all in one
    all-reduce; the others as they are, and no collective where none is
    split.  Differentiable: each split tensor gets this rank's slice of its
    whole gradient."""
    held = []
    for name, t in tensors.items():
        owner, _, attr = name.rpartition(".")
        layer = module.get_submodule(owner) if owner else module
        if attr in getattr(layer, "splits", {}):
            held.append((name, layer.mesh, layer.splits[attr]))
    if not held:
        return dict(tensors)
    mesh = held[0][1]
    wholes = _AssembleParams.apply(mesh, tuple(spec for _, _, spec in held), *(tensors[n] for n, _, _ in held))
    return {**tensors, **{n: w for (n, _, _), w in zip(held, wholes)}}


def row_convs(net: nn.Module, size: int = 0) -> Dict[str, Split]:
    """Row splits of every non-grouped convolution of ``net`` at least
    MIN_ROW_CHANNELS wide at its input; with ``size``, only those whose
    input divides by it (the UNets' rule; without, a width that does not
    divide raises in :func:`check_plan`)."""
    return {name: Split(ROW) for name, m in net.named_modules()
            if isinstance(m, nn.Conv2d) and m.groups == 1 and m.in_channels >= MIN_ROW_CHANNELS
            and not (size and m.in_channels % size)}


def layer_splits(split: Split, bias: bool) -> Dict[str, Tuple[int, int]]:
    """``{parameter: (dim, chunks)}`` of the parameters a layer split by
    ``split`` holds sliced (a row split's bias stays whole)."""
    if split.kind == COLUMN:
        return {"weight": (0, split.chunks), **({"bias": (0, split.chunks)} if bias else {})}
    return {"weight": (1, 1)}


def param_splits(net: nn.Module, plan: Mapping[str, Split]) -> Dict[str, Tuple[int, int]]:
    """``{parameter name: (dim, chunks)}`` of the parameters ``plan`` splits."""
    return {f"{name}.{k}": spec for name, split in plan.items()
            for k, spec in layer_splits(split, getattr(net.get_submodule(name), "bias", None) is not None).items()}


def check_plan(net: nn.Module, plan: Mapping[str, Split], size: int) -> None:
    """Raise where a layer of ``plan`` is not one the split layers take or
    a split width does not divide by ``size``."""
    for name, split in plan.items():
        layer = net.get_submodule(name)
        if split.kind == COLUMN and isinstance(layer, nn.Linear):
            width, what = layer.out_features // split.chunks, "output features per chunk"
            if layer.out_features % split.chunks:
                raise ValueError(f"tensor parallelism: {name}: {layer.out_features} features in {split.chunks} chunks")
        elif split.kind == ROW and isinstance(layer, nn.Linear):
            width, what = layer.in_features, "input features"
        elif split.kind == ROW and isinstance(layer, nn.Conv2d):
            width, what = layer.in_channels, "input channels"
        else:
            raise ValueError(f"tensor parallelism: {name}: no {split.kind} split of {type(layer).__name__}")
        if width % size:
            raise ValueError(f"tensor parallelism: {name}: {width} {what} do not divide by model_parallel={size}")


def plan_of(net: nn.Module, size: int) -> Dict[str, Split]:
    """The net's plan for ``size`` model ranks (its ``tensor_parallel_plan``);
    a net without one raises, naming it: no request is quietly replicated."""
    plan = getattr(net, "tensor_parallel_plan", None)
    if plan is None:
        raise ValueError(f"tensor parallelism: {type(net).__name__} has no tensor-parallel plan "
                         f"(model_parallel={size}); nets with one: {', '.join(PLANNED)}")
    plan = plan(size)
    check_plan(net, plan, size)
    return plan


def split_share(net: nn.Module, plan: Mapping[str, Split]) -> Tuple[float, list]:
    """(the share of the whole net's parameter bytes that ``plan`` splits,
    the names of the split parameters); works on a net on the meta device."""
    splits = param_splits(net, plan)
    nbytes = {k: p.numel() * p.element_size() for k, p in net.named_parameters()}
    return sum(nbytes[k] for k in splits) / sum(nbytes.values()), sorted(splits)


_LAYERS = {(COLUMN, nn.Linear): ColumnLinear, (ROW, nn.Linear): RowLinear, (ROW, nn.Conv2d): RowConv2d}


def _split_layer(layer: nn.Module, split: Split, mesh) -> nn.Module:
    for (kind, cls), split_cls in _LAYERS.items():
        if split.kind == kind and isinstance(layer, cls):
            return split_cls(layer, split, mesh)
    raise ValueError(f"tensor parallelism: no {split.kind} split of {type(layer).__name__}")


class Layout:
    """Which parameters of a split net hold this rank's slice of a whole
    tensor (``splits``: name -> (dim, chunks)), and the conversions."""

    def __init__(self, splits: Mapping[str, Tuple[int, int]], mesh, share: float):
        self.splits, self.mesh, self.share = dict(splits), mesh, share
        self.rank, self.size, self.group = mesh.model_rank, mesh.model_size, mesh.model_group

    def shard(self, tensors: Mapping[str, torch.Tensor]) -> dict:
        """Whole tensors (a state dict in the reference's key space, the EMA's
        parameters, per-parameter moments) -> this rank's: each split one
        sliced, the others as they are."""
        return {k: take_slice(v, *self.splits[k], self.rank, self.size) if k in self.splits else v
                for k, v in tensors.items()}

    def whole(self, tensors: Mapping[str, torch.Tensor]) -> dict:
        """This rank's tensors -> the whole ones, on every rank of the model
        group: a collective, which each of its ranks calls with the same
        names in the same order."""
        return {k: assemble(v.detach(), *self.splits[k], self.rank, self.size, self.group) if k in self.splits
                else v for k, v in tensors.items()}

    def average_replicated_grads(self, net: nn.Module) -> None:
        """Average the gradients of the parameters that every rank holds
        whole over the model group (one all-reduce of them flattened).
        Each rank computes the same gradient, but a backward that is not
        deterministic on the card (atomic adds: a nearest upsample's, some
        cuDNN weight gradients) rounds it otherwise on each rank, and
        replicas that step on different gradients drift apart."""
        grads = [p.grad for k, p in net.named_parameters() if k not in self.splits and p.grad is not None]
        if not grads:
            return
        flat = torch._utils._flatten_dense_tensors(grads)
        tdist.all_reduce(flat, group=self.group)
        flat /= self.size
        for g, v in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
            g.copy_(v)

    def shard_bytes(self, net: nn.Module) -> int:
        """The bytes of the parameters this rank holds."""
        return sum(p.numel() * p.element_size() for p in net.parameters())


def parallelize(net: nn.Module, mesh) -> Layout:
    """Split ``net`` in place over ``mesh``'s model group by its plan: each
    planned layer replaced by its split layer, which takes this rank's
    slice of the whole parameters (every rank must hold the same whole
    net).  Returns the layout of the split parameters."""
    plan = plan_of(net, mesh.model_size)
    share = split_share(net, plan)[0]
    splits = param_splits(net, plan)
    for name, split in plan.items():
        parent, _, attr = name.rpartition(".")
        owner = net.get_submodule(parent) if parent else net
        setattr(owner, attr, _split_layer(getattr(owner, attr), split, mesh))
    return Layout(splits, mesh, share)
