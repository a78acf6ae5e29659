"""Tiled restoration for images larger than one sampler call (PyTorch).

Counterpart of ``image_restoration_sde_tpu/tiling.py``: the image is split
into overlapping tiles of one shape (edge tiles shift inward, they are not
padded), the tiles run through ``sample_fn`` ``tile_batch`` at a time, and
they are blended with a separable raised-cosine feather so that seams
vanish.  Same grid and feather as the JAX package.

``sample_fn(tiles, gens) -> restored`` takes an NHWC float32 batch of
tiles on ``device`` and one ``torch.Generator`` per tile (or None when
``seed`` is None, for samplers that draw nothing); the port's samplers
(``sampling.make_restoration_sampler``, ``training.make_latent_sampler``)
take them as they are.  Tile i's generator is seeded from ``seed`` and i,
the tile's index in the whole grid, so the result does not depend on
``tile_batch``.  (The JAX package folds the index of the chunk of tiles
into its key instead, so its noise changes with ``tile_batch``.)

uint8 in gives uint8 out (scaled to [0, 1] for the sampler, then rounded
and clipped); float32 in gives float32 out.  The last chunk runs at its
own size: eager PyTorch has no compiled batch shape to pad it to.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .sde import rng

Coords = List[Tuple[int, int]]


def _feather_profile(size: int, overlap: int) -> np.ndarray:
    """1-D blend weights: raised-cosine ramps across the overlap bands."""
    w = np.ones(size, dtype=np.float32)
    if overlap > 0:
        ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(overlap) + 0.5) / overlap)
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return w


def tile_grid(length: int, tile: int, overlap: int) -> List[int]:
    """Start offsets covering [0, length) with ``tile``-sized windows."""
    if length <= tile:
        return [0]
    stride = tile - overlap
    n = math.ceil((length - tile) / stride) + 1
    starts = [min(i * stride, length - tile) for i in range(n)]
    return list(dict.fromkeys(starts))  # the clamp can repeat the last start


def _layout(H: int, W: int, tile: int, overlap: int) -> Tuple[int, int, Coords, np.ndarray]:
    """Tile height and width, tile corners, and the (th, tw, 1) blend weights."""
    th, tw = min(tile, H), min(tile, W)
    coords = [(y, x) for y in tile_grid(H, th, overlap) for x in tile_grid(W, tw, overlap)]
    wy = _feather_profile(th, min(overlap, th // 2))
    wx = _feather_profile(tw, min(overlap, tw // 2))
    return th, tw, coords, (wy[:, None] * wx[None, :])[..., None]


def _restored_chunks(sample_fn: Callable, tiles_at: Callable, coords: Coords, tile_batch: int,
                     seed: Optional[int], device) -> Iterator[Tuple[Coords, torch.Tensor]]:
    """(corners, restored tiles) for each chunk of ``tile_batch`` tiles."""
    for i in range(0, len(coords), tile_batch):
        chunk = coords[i : i + tile_batch]
        gens = None if seed is None else [rng.generator(rng.fold_seed(seed, i + j), device) for j in range(len(chunk))]
        yield chunk, sample_fn(tiles_at(chunk), gens)


def _check(lq: np.ndarray, tile_batch: int) -> None:
    if lq.ndim != 4 or lq.shape[0] != 1:
        raise ValueError(f"tiled restoration takes one NHWC image (1, H, W, C), not {lq.shape}")
    if tile_batch < 1:
        raise ValueError(f"tile_batch {tile_batch} < 1")


def _unit(lq: np.ndarray) -> np.ndarray:
    return lq.astype(np.float32) / 255.0 if lq.dtype == np.uint8 else lq.astype(np.float32, copy=False)


def tiled_restore(sample_fn: Callable, lq: np.ndarray, seed: Optional[int], tile: int = 512, overlap: int = 64,
                  tile_batch: int = 4, device="cuda") -> np.ndarray:
    """Restore an NHWC batch-1 image by overlapping tiles, blending on the
    host: each chunk of tiles goes to ``device`` and back."""
    _check(lq, tile_batch)
    _, H, W, C = lq.shape
    th, tw, coords, weight = _layout(H, W, tile, overlap)
    x = _unit(lq)

    def tiles_at(chunk):
        return torch.from_numpy(np.concatenate([x[:, y : y + th, c : c + tw] for y, c in chunk])).to(device)

    acc = np.zeros((H, W, C), np.float64)
    norm = np.zeros((H, W, 1), np.float64)
    for chunk, out in _restored_chunks(sample_fn, tiles_at, coords, tile_batch, seed, device):
        for t_img, (y, c) in zip(out.float().cpu().numpy(), chunk):
            acc[y : y + th, c : c + tw] += t_img * weight
            norm[y : y + th, c : c + tw] += weight
    out = (acc / np.maximum(norm, 1e-8)).astype(np.float32)[None]
    if lq.dtype == np.uint8:
        return np.round(np.clip(out, 0.0, 1.0) * 255.0).astype(np.uint8)
    return out


def tiled_restore_device(sample_fn: Callable, lq: np.ndarray, seed: Optional[int], tile: int = 512,
                         overlap: int = 64, tile_batch: int = 4, device="cuda") -> np.ndarray:
    """``tiled_restore`` with the image uploaded once (uint8 stays uint8 on
    the way), tiles sliced on ``device``, the blend accumulated there in
    float32 (in place), and one download of the finished image."""
    _check(lq, tile_batch)
    _, H, W, C = lq.shape
    th, tw, coords, weight = _layout(H, W, tile, overlap)
    img = torch.from_numpy(np.ascontiguousarray(lq[0])).to(device)
    x = img.float() / 255.0 if lq.dtype == np.uint8 else img.float()
    w = torch.from_numpy(weight).to(device)

    def tiles_at(chunk):
        return torch.stack([x[y : y + th, c : c + tw] for y, c in chunk])

    acc = torch.zeros((H, W, C), dtype=torch.float32, device=device)
    norm = torch.zeros((H, W, 1), dtype=torch.float32, device=device)
    for chunk, out in _restored_chunks(sample_fn, tiles_at, coords, tile_batch, seed, device):
        for t_img, (y, c) in zip(out.float(), chunk):
            acc[y : y + th, c : c + tw] += t_img * w
            norm[y : y + th, c : c + tw] += w
    out = acc / norm.clamp_min(1e-8)
    if lq.dtype == np.uint8:
        out = torch.round(out.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return out[None].cpu().numpy()
