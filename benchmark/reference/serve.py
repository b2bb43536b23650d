"""The plain reference of a masks call: (F, H, W) frames in [0, 1] ->
(F, H, W) uint8 masks, by the overlap-tile strategy of the U-Net paper.

For each TTA flip of the frames (identity; or the identity and flips of
rows, of columns and of both): mirror-pad each frame by half the net's
margin on the top and left and by the rest, plus the ragged edge, on the
bottom and right (numpy's "reflect", or "symmetric" where a pad reaches
the frame's side); cut tiles of `tile_input` at a stride of the output
size, in raster order; normalise each tile (per-tile z-score with the
population std floored at 1e-6 when standardising); run every member's
eval-mode forward; take each member's foreground probability (softmax
channel 1); merge members (vote: each thresholded, then a strict
majority); stitch the disjoint output tiles, crop to the frame and undo
the flip. Then merge the flips (vote: thresholded, strict majority; mean:
the mean probability over the threshold). Beside the masks it returns
the members' foreground probability averaged over members and flips,
which says how near the threshold each pixel lies. The members' forward
is the configuration's architecture module's (`arch`,
reference/<architecture>.py). Plain PyTorch in float32; imports nothing of
the program.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

FLIPS = {"none": [()], "flips": [(), (-2,), (-1,), (-2, -1)]}


def pad_index(n: int, before: int, after: int) -> np.ndarray:
    mode = "symmetric" if max(before, after) >= n else "reflect"
    return np.pad(np.arange(n), (before, after), mode=mode)


def output_size(size: int, levels: int) -> int:
    s = size
    for lvl in range(levels):
        s = (s // 2 if lvl else s) - 4
    for _ in range(levels - 1):
        s = s * 2 - 4
    return s


def member_probs(nets: Sequence[tuple], tiles: torch.Tensor, arch, model: Dict[str, Any],
                 merge: str, threshold: float, quant: Optional[Callable] = None) -> torch.Tensor:
    """(n, T, T) normalised tiles -> (2, n, o, o): the merged foreground
    values and the members' mean foreground probability."""
    acc = mean = None
    for params, stats in nets:
        logits, _ = arch.forward(params, stats, tiles[:, None], model, quant=quant)
        p = torch.softmax(logits, dim=1)[:, 1]
        mean = p if mean is None else mean + p
        if len(nets) > 1 and merge == "vote":
            p = (p > threshold).float()
        acc = p if acc is None else acc + p
    m = len(nets)
    if m > 1 and merge == "vote":
        return torch.stack([(acc * 2 > m).float(), mean / m])
    return torch.stack([acc / m, mean / m])


@torch.no_grad()
def masks(frames: torch.Tensor, nets: Sequence[tuple], arch, model: Dict[str, Any],
          tile_input: int, tta: str, tta_merge: str, ensemble_merge: str, standardize: bool,
          threshold: float, block: int = 4, quant: Optional[Callable] = None):
    """(F, H, W) f32 frames on the reference's device -> ((F, H, W) uint8
    masks, (F, H, W) f32 mean foreground probability over members and
    flips). `nets` is [(params, stats)] per member (nets_from); the
    forwards run `block` tiles at a time."""
    f, h, w = frames.shape
    o = output_size(tile_input, model["levels"])
    margin = tile_input - o
    ny, nx = math.ceil(h / o), math.ceil(w / o)
    top = left = margin // 2
    iy = torch.from_numpy(pad_index(h, top, ny * o - h + margin - top)).to(frames.device)
    ix = torch.from_numpy(pad_index(w, left, nx * o - w + margin - left)).to(frames.device)
    per_flip: List[torch.Tensor] = []
    for dims in FLIPS[tta]:
        x = frames.flip(dims) if dims else frames
        padded = x.index_select(1, iy).index_select(2, ix)
        tiles = torch.stack([padded[:, i * o:i * o + tile_input, j * o:j * o + tile_input]
                             for i in range(ny) for j in range(nx)], dim=1)
        tiles = tiles.reshape(-1, tile_input, tile_input)
        if standardize:
            mu = tiles.mean(dim=(1, 2), keepdim=True)
            sd = tiles.std(dim=(1, 2), keepdim=True, correction=0).clamp_min(1e-6)
            tiles = (tiles - mu) / sd
        out = torch.cat([member_probs(nets, tiles[s:s + block], arch, model, ensemble_merge,
                                      threshold, quant)
                         for s in range(0, tiles.shape[0], block)], dim=1)
        out = out.reshape(2, f, ny, nx, o, o).permute(0, 1, 2, 4, 3, 5)
        out = out.reshape(2, f, ny * o, nx * o)[..., :h, :w]
        per_flip.append(out.flip(dims) if dims else out)
    n = len(per_flip)
    soft = sum(p[1] for p in per_flip) / n
    if tta_merge == "vote":
        votes = sum((p[0] > threshold).int() for p in per_flip)
        return (votes * 2 > n).to(torch.uint8), soft
    if tta_merge == "mean":
        return (sum(p[0] for p in per_flip) / n > threshold).to(torch.uint8), soft
    raise ValueError(f"tta_merge {tta_merge!r} has no reference")


def nets_from(arch, variables_list, device) -> List[tuple]:
    """[(params, stats)] of each member's Flax-layout variables."""
    return [arch.to_tensors(v, device) for v in variables_list]

