"""U-Net pixel weight maps: class balance plus the instance-separation term
(counterpart of unetseg_tpu/ops/weight_maps.py; the host functions are
copies, the device path is the port's own).

The reference generator (scripts/preprocess_data.py:17-77, w0 10, sigma 5)
takes each instance's distance as min(EDT(obj), EDT(obj == 0)), which is
identically 0 whenever both classes are present, so its separation term
degenerates to a constant w0: `mode="reference"` reproduces that bit for
bit. `mode="paper"` computes the U-Net paper's term with d1 and d2 the
distances to the nearest and second-nearest cell.
"""

from __future__ import annotations

from typing import Literal, Optional, Union

import numpy as np
import torch

from unetseg_tpu_torch.ops.edt import BIG, edt_sq

Mode = Literal["reference", "paper"]

# The JAX package rounds the label count up to one of these static sizes
# for jit; the port keeps pack_labels so that its labels match, but the
# dispatcher does not route through it: the device path takes any number
# of instances and drops the -1 padding of packed labels.
INSTANCE_BUCKETS = (32, 64, 128, 256)
# Instances per batch of EDT planes: K planes of a 512^2 frame hold K MB
# per f32 plane and edt_sq keeps several, so a frame's instances go through
# in chunks of at most this many, merged into a running top-2.
EDT_CHUNK = 256


# --------------------------------------------------------------------- host
def class_balance_weights_np(binary_mask: np.ndarray) -> np.ndarray:
    """w_c: inverse class frequency per pixel (reference :26-36)."""
    binary_mask = (binary_mask > 0).astype(np.uint8)
    total = binary_mask.size
    n_fg = int(binary_mask.sum())
    n_bg = total - n_fg
    wc_bg = (total / n_bg) if n_bg > 0 else 0.0
    wc_fg = (total / n_fg) if n_fg > 0 else 0.0
    out = np.zeros(binary_mask.shape, np.float32)
    out[binary_mask == 0] = wc_bg
    out[binary_mask == 1] = wc_fg
    return out


def weight_map_np(
    instance_mask: np.ndarray, w0: float = 10.0, sigma: float = 5.0,
    mode: Mode = "reference",
) -> np.ndarray:
    """Host (scipy) weight map. mode='reference' is the reference formula
    including its degenerate distance term; mode='paper' the real one."""
    from scipy.ndimage import distance_transform_edt as sp_edt

    mask = np.asarray(instance_mask)
    wc = class_balance_weights_np(mask)
    labels = np.unique(mask[mask > 0])

    h, w = mask.shape
    if len(labels) == 0:
        d1 = np.zeros((h, w), np.float32)
        d2 = np.zeros((h, w), np.float32)
    else:
        dist_maps = []
        for lab in labels:
            obj = (mask == lab).astype(np.uint8)
            if mode == "reference":
                # reference :47 — min of the two EDTs (degenerates to 0)
                d = np.minimum(sp_edt(obj), sp_edt(obj == 0))
            else:
                d = sp_edt(mask != lab)  # distance to cell `lab` (0 inside it)
            dist_maps.append(d.astype(np.float32))
        stacked = np.stack(dist_maps, axis=-1)
        if stacked.shape[-1] >= 2:
            part = np.partition(stacked, kth=1, axis=-1)[:, :, :2]
            d1, d2 = part[:, :, 0], part[:, :, 1]
        else:
            d1 = stacked[:, :, 0]
            d2 = np.zeros_like(d1)

    d1 = np.where(np.isinf(d1), 0.0, d1)
    d2 = np.where(np.isinf(d2), 0.0, d2)
    sep = w0 * np.exp(-((d1 + d2) ** 2) / (2 * (sigma**2 + 1e-8)))
    if mode == "paper":
        # the separation term only matters off-cell; reference mode keeps
        # it everywhere (that is what the reference does)
        sep = sep * (mask == 0)
    # float64 accumulation like the reference (numpy default), cast at the end
    return (wc.astype(np.float64) + sep.astype(np.float64)).astype(np.float32)


def pack_labels(instance_mask: np.ndarray, max_instances: Optional[int] = None) -> np.ndarray:
    """Unique positive labels padded with -1 to a static length: the
    smallest INSTANCE_BUCKETS entry that fits when `max_instances` is None."""
    labels = np.unique(np.asarray(instance_mask))
    labels = labels[labels > 0].astype(np.int32)
    if max_instances is None:
        for b in INSTANCE_BUCKETS:
            if labels.size <= b:
                max_instances = b
                break
        else:
            raise ValueError(f"{labels.size} instances > max bucket {INSTANCE_BUCKETS[-1]}")
    elif labels.size > max_instances:
        raise ValueError(f"{labels.size} instances > max_instances={max_instances}")
    out = np.full((max_instances,), -1, np.int32)
    out[: labels.size] = labels
    return out


# ------------------------------------------------------------------- device
def weight_map_device(
    instance_mask: torch.Tensor, labels: torch.Tensor, w0: float = 10.0, sigma: float = 5.0,
) -> torch.Tensor:
    """The 'paper' weight map on the mask's device: exact per-instance
    squared EDTs (ops/edt.py) of the frame's instances in batches of at
    most EDT_CHUNK, so each EDT phase is one min-plus launch per batch; the
    two smallest distances per pixel by torch.topk, each batch's merged
    with the pair so far (a min over the same values: the result does not
    depend on the chunking); the separation term, off the cells. `labels`:
    the instances' label values, any number; entries <= 0 are ignored (the
    -1 padding of pack_labels). (H, W) -> (H, W) f32."""
    mask = instance_mask.to(torch.int32)
    h, w = mask.shape
    fg = mask > 0
    n_fg = fg.sum()
    total = h * w
    n_bg = total - n_fg
    wc_fg = torch.where(n_fg > 0, total / n_fg.float(), 0.0)
    wc_bg = torch.where(n_bg > 0, total / n_bg.float(), 0.0)
    wc = torch.where(fg, wc_fg, wc_bg)

    labs = labels.to(device=mask.device, dtype=torch.int32)
    labs = labs[labs > 0]
    n_valid = int(labs.numel())
    # the running pair starts at BIG: absent instances never win the min
    two = torch.full((2, h, w), BIG, device=mask.device)
    for i in range(0, n_valid, EDT_CHUNK):
        planes = edt_sq(mask[None] == labs[i : i + EDT_CHUNK, None, None])
        two = torch.topk(torch.cat([two, planes]), 2, dim=0, largest=False).values
    d1 = torch.sqrt(torch.clamp_max(two[0], BIG))
    d2 = torch.sqrt(torch.clamp_max(two[1], BIG))
    if n_valid < 1:
        d1 = torch.zeros_like(d1)
    if n_valid < 2:
        d2 = torch.zeros_like(d2)
    # guard the no/one-instance cases like the reference (:56-64)
    d1 = torch.where(d1 > 1e5, 0.0, d1)
    d2 = torch.where(d2 > 1e5, 0.0, d2)
    sep = w0 * torch.exp(-((d1 + d2) ** 2) / (2 * (sigma**2 + 1e-8)))
    return (wc + sep * (~fg)).float()


def weight_map(
    instance_mask: np.ndarray, w0: float = 10.0, sigma: float = 5.0, mode: Mode = "reference",
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """The preprocess command's dispatcher: the 'paper' map runs
    weight_map_device on `device` (the card unless the caller asks for the
    CPU) with every instance of the frame; the 'reference' formula has no
    device version and runs on the host (scipy) whatever `device` says."""
    if mode == "paper":
        m = np.asarray(instance_mask).astype(np.int32)
        labels = torch.from_numpy(np.unique(m[m > 0])).to(device)
        return weight_map_device(torch.from_numpy(m).to(device), labels, w0=w0,
                                 sigma=sigma).cpu().numpy()
    return weight_map_np(instance_mask, w0=w0, sigma=sigma, mode=mode)
