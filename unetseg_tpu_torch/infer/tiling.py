"""Overlap-tile inference (counterpart of unetseg_tpu/infer/tiling.py).

Mirror-pad by half the valid-conv margin, run the net on overlapping
input tiles, and concatenate the disjoint output tiles (the U-Net paper's
overlap-tile strategy). Images and probabilities are torch tensors on the
caller's device; the tile grid is plain Python.

With a mesh (core/mesh.MeshSpec) the tiles are sharded over its ranks
(data x tile axes, as the JAX tile sharding): each chunk's tile count is
padded to a multiple of the ranks, each rank runs its contiguous share
through `tile_fn` on its own device, and the shares are gathered (an
all-reduce into a zeroed buffer, which gloo and nccl both take and which
is exact). Tiles are independent, so every rank ends with the
single-rank result, up to what a rank's smaller chunk changes in
`tile_fn` itself (cuDNN picks its algorithm by the batch).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from unetseg_tpu_torch.core.distributed import gather_shares
from unetseg_tpu_torch.core.mesh import MeshSpec
from unetseg_tpu_torch.models.shapes import output_size


@dataclass(frozen=True)
class TileGrid:
    """Geometry of one tiled run over an (h, w) image."""

    h: int
    w: int
    tile_in: int     # network input tile size (e.g. 512)
    tile_out: int    # network output tile size (e.g. 324)
    ny: int
    nx: int
    pad_top: int
    pad_left: int
    pad_bottom: int
    pad_right: int

    @property
    def num_tiles(self) -> int:
        return self.ny * self.nx


def min_tile_input(cover: int, levels: int = 5, search: int = 256) -> int:
    """Smallest valid network input size whose output covers `cover` pixels
    (fewer, larger tiles recompute less of the valid-conv margin: one
    700 -> 516 tile for a 512 frame instead of four 512 -> 324 tiles)."""
    for t in range(cover, cover + max(search, cover) + 1):
        try:
            if output_size(t, levels) >= cover:
                return t
        except ValueError:
            continue
    raise ValueError(f"no valid tile input covering {cover}px found")


def plan_tiles(h: int, w: int, tile_in: int = 512) -> TileGrid:
    """Outputs tile the image exactly (stride = tile_out); input context
    comes from mirror padding by margin/2 plus ragged-edge padding on the
    bottom/right."""
    tile_out = output_size(tile_in)
    margin = tile_in - tile_out
    ny = math.ceil(h / tile_out)
    nx = math.ceil(w / tile_out)
    pad_top = margin // 2
    pad_left = margin // 2
    pad_bottom = (ny * tile_out - h) + (margin - margin // 2)
    pad_right = (nx * tile_out - w) + (margin - margin // 2)
    return TileGrid(
        h=h, w=w, tile_in=tile_in, tile_out=tile_out, ny=ny, nx=nx,
        pad_top=pad_top, pad_left=pad_left,
        pad_bottom=pad_bottom, pad_right=pad_right,
    )


def _pad_index(n: int, before: int, after: int, mode: str) -> np.ndarray:
    return np.pad(np.arange(n), (before, after), mode=mode)


def mirror_pad(images: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Reflect-pad the trailing (H, W) axes (the paper's mirroring); symmetric
    mode when a pad reaches the image extent (reflect needs pad < dim), as
    numpy's modes define them."""
    h, w = images.shape[-2], images.shape[-1]
    mode = "reflect"
    if max(grid.pad_top, grid.pad_bottom) >= h or max(
        grid.pad_left, grid.pad_right
    ) >= w:
        mode = "symmetric"
    iy = _pad_index(h, grid.pad_top, grid.pad_bottom, mode)
    ix = _pad_index(w, grid.pad_left, grid.pad_right, mode)
    dev = images.device
    rows = images.index_select(-2, torch.from_numpy(iy).to(dev))
    return rows.index_select(-1, torch.from_numpy(ix).to(dev))


def extract_tiles(padded: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(..., Hp, Wp) -> (..., ny*nx, tile_in, tile_in), raster order."""
    t = grid.tile_in
    tiles = [
        padded[..., i * grid.tile_out : i * grid.tile_out + t,
               j * grid.tile_out : j * grid.tile_out + t]
        for i in range(grid.ny)
        for j in range(grid.nx)
    ]
    return torch.stack(tiles, dim=-3)


def stitch(outputs: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(..., ny*nx, tile_out, tile_out) -> (..., h, w): output tiles are
    disjoint, so a reshape and permute, then a crop of the ragged edge."""
    o = grid.tile_out
    lead = outputs.shape[:-3]
    x = outputs.reshape(*lead, grid.ny, grid.nx, o, o)
    nd = len(lead)
    x = x.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)
    x = x.reshape(*lead, grid.ny * o, grid.nx * o)
    return x[..., : grid.h, : grid.w]


def pad_tile_count(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def shard_tile_fn(
    tile_fn: Callable[[torch.Tensor], torch.Tensor], mesh: Optional[MeshSpec]
) -> Callable[[torch.Tensor], torch.Tensor]:
    """tile_fn over a chunk whose size divides by the mesh's tile shards:
    this rank runs its contiguous share, and the shares are gathered.
    `tile_fn` itself without a mesh or with one tile shard."""
    if mesh is None or mesh.num_tile_shards == 1:
        return tile_fn
    n_shards, index = mesh.num_tile_shards, mesh.tile_shard_index

    def run(chunk: torch.Tensor) -> torch.Tensor:
        k = chunk.shape[0] // n_shards
        share = tile_fn(chunk[index * k : (index + 1) * k])
        return gather_shares(share, chunk.shape[0], index, mesh.tile_group)

    return run


def _chunk_size(batch: int, mesh: Optional[MeshSpec]) -> int:
    """A chunk's tile count: `batch`, padded to a multiple of the ranks
    that share it."""
    return batch if mesh is None else pad_tile_count(batch, mesh.num_tile_shards)


def _stitch_any(outputs: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(n, o, o) or (n, o, o, C) per-tile outputs -> (h, w) or (h, w, C)."""
    if outputs.dim() == 3:
        return stitch(outputs, grid)
    return stitch(outputs.movedim(-1, 0), grid).movedim(0, -1)


def make_tiled_fn(
    tile_fn: Callable[[torch.Tensor], torch.Tensor],
    grid: TileGrid,
    tile_batch: Optional[int] = None,
    mesh: Optional[MeshSpec] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn(image (H, W)) -> stitched (h, w) or (h, w, C) on the image's
    device: mirror-pad -> extract -> per-chunk forward -> stitch.

    The tile count is padded to a multiple of `tile_batch` with copies of
    tile 0, so that every chunk has one batch size, as in the JAX version.
    `tile_fn(chunk (B, T, T))` returns (B, o, o) binary probabilities or
    (B, o, o, C) class probabilities. With a `mesh` each chunk's tiles are
    sharded over its ranks (see the module docstring)."""
    n = grid.num_tiles
    batch = _chunk_size(tile_batch or n, mesh)
    n_padded = pad_tile_count(n, batch)
    tile_fn = shard_tile_fn(tile_fn, mesh)

    def run(image: torch.Tensor) -> torch.Tensor:
        tiles = extract_tiles(mirror_pad(image, grid), grid)
        if n_padded > n:
            tiles = torch.cat([tiles, tiles[:1].expand(n_padded - n, -1, -1)])
        outs = [tile_fn(tiles[s : s + batch]) for s in range(0, n_padded, batch)]
        return _stitch_any(torch.cat(outs)[:n], grid)

    return run


def tiled_apply(
    tile_fn: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,
    grid: TileGrid,
    tile_batch: Optional[int] = None,
    mesh: Optional[MeshSpec] = None,
) -> torch.Tensor:
    """Run `tile_fn` ((B, T, T) -> (B, o, o) or (B, o, o, C)) over all tiles
    of `image` in chunks of `tile_batch` and stitch; a ragged last chunk is
    padded with copies of its first tile and the padding's outputs are
    dropped. With a `mesh` each chunk's tiles are sharded over its ranks."""
    tiles = extract_tiles(mirror_pad(image, grid), grid)
    n = grid.num_tiles
    tile_batch = _chunk_size(tile_batch or n, mesh)
    tile_fn = shard_tile_fn(tile_fn, mesh)
    outs = []
    for start in range(0, n, tile_batch):
        chunk = tiles[start : start + tile_batch]
        pad = tile_batch - chunk.shape[0]
        if pad:
            chunk = torch.cat([chunk, chunk[:1].expand(pad, -1, -1)])
        outs.append(tile_fn(chunk)[: tile_batch - pad])
    return _stitch_any(torch.cat(outs), grid)


def _t(x: torch.Tensor) -> torch.Tensor:
    """Transpose the trailing (H, W) axes (square frames only)."""
    return x.transpose(-2, -1)


def _fy(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(-2,))


def _fx(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(-1,))


def _fyx(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(-2, -1))


def _id(x: torch.Tensor) -> torch.Tensor:
    return x


#: test-time augmentation transforms: (forward, inverse) pairs on (..., H, W)
#: images / probability maps, applied to the full frame and inverted on the
#: full stitched probabilities.
TTA_TRANSFORMS = {
    "none": [(_id, _id)],
    "flips": [(_id, _id), (_fy, _fy), (_fx, _fx), (_fyx, _fyx)],
    # the dihedral group D4 (flips x transpose), square frames only; the
    # inverse of (transpose then flip) is (unflip then transpose)
    "flips8": [
        (_id, _id), (_fy, _fy), (_fx, _fx), (_fyx, _fyx),
        (_t, _t),
        (lambda x: _fy(_t(x)), lambda x: _t(_fy(x))),
        (lambda x: _fx(_t(x)), lambda x: _t(_fx(x))),
        (lambda x: _fyx(_t(x)), lambda x: _t(_fyx(x))),
    ],
}


def make_tiled_mask_batch_fn(
    tile_fn: Callable[[torch.Tensor], torch.Tensor],
    grid: TileGrid,
    n_frames: int,
    threshold: float,
    tile_batch: Optional[int] = None,
    tta: str = "none",
    tta_merge: str = "mean",
    mesh: Optional[MeshSpec] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Frame-batched tiled binary segmentation:
    fn(images (F, H, W) f32) -> (F, H, W) uint8, on the images' device.

    All frames' tiles are pooled into fixed-size forward chunks of
    `tile_batch` (the last chunk padded with copies of the first tile), each
    frame is stitched, and the threshold is applied on the device.
    `tile_fn(chunk (B, T, T))` returns (B, o, o) foreground probabilities.
    With a `mesh` each chunk's tiles are sharded over its ranks."""
    n = grid.num_tiles
    total = n_frames * n
    batch = _chunk_size(tile_batch or total, mesh)
    n_padded = pad_tile_count(total, batch)
    tile_fn = shard_tile_fn(tile_fn, mesh)

    if tta == "flips8" and grid.h != grid.w:
        raise ValueError(
            f"tta='flips8' transposes frames and needs square inputs; "
            f"got {grid.h}x{grid.w}"
        )
    transforms = TTA_TRANSFORMS[tta]

    def frame_probs(images: torch.Tensor) -> torch.Tensor:
        tiles = extract_tiles(mirror_pad(images, grid), grid)
        tiles = tiles.reshape(total, grid.tile_in, grid.tile_in)
        if n_padded > total:
            tiles = torch.cat([tiles, tiles[:1].expand(n_padded - total, -1, -1)])
        outs = [tile_fn(tiles[s : s + batch]) for s in range(0, n_padded, batch)]
        outputs = torch.cat(outs)[:total]
        if outputs.dim() != 3:
            raise ValueError(
                "make_tiled_mask_batch_fn expects a binary (B, o, o) "
                f"foreground-probability head, got {tuple(outputs.shape)}"
            )
        return stitch(outputs.reshape(n_frames, n, *outputs.shape[1:]), grid)

    def run(images: torch.Tensor) -> torch.Tensor:
        all_p = [inv(frame_probs(fwd(images))) for fwd, inv in transforms]
        return merge_tta_probs(all_p, threshold, tta_merge)

    return run


def merge_tta_probs(
    probs: List[torch.Tensor], threshold: float, merge: str = "mean"
) -> torch.Tensor:
    """Combine per-transform foreground probabilities into a uint8 mask:
    "mean" (arithmetic), "gmean" (geometric: one near-zero vote keeps the
    pixel background, protecting separating membranes), "vote" (strict
    per-transform majority), "max" (union)."""
    n = len(probs)
    if merge == "mean":
        p = sum(probs) / n
        return (p > threshold).to(torch.uint8)
    if merge == "gmean":
        eps = 1e-7
        logp = sum(torch.log(p + eps) for p in probs) / n
        return (torch.exp(logp) > threshold).to(torch.uint8)
    if merge == "vote":
        votes = sum((p > threshold).to(torch.int32) for p in probs)
        return (votes * 2 > n).to(torch.uint8)
    if merge == "max":
        p = torch.stack(probs).amax(dim=0)
        return (p > threshold).to(torch.uint8)
    raise ValueError(f"unknown tta_merge {merge!r}")
