"""Valid-convolution shape algebra for the U-Net.

The reference computes these sizes by tracing a dummy forward pass
(reference: models/unet_model.py:148-223 traces 572->388 and 512->324;
scripts/predict1.py:45-46 probes the 188-px margin at 512). Here the algebra
is closed-form and testable, which the tiling engine, the training-target
crop, and the tests all rely on. Crucially it replicates floor division for
max-pooling of odd sizes (e.g. 121 -> 60), which the 512 -> 324 result depends
on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

CONV_SHRINK = 4  # two valid 3x3 convs per block


@dataclass(frozen=True)
class UNetShapes:
    """All intermediate spatial sizes for one spatial dimension."""

    input_size: int
    encoder: Tuple[int, ...]   # x1..x5 sizes after each DoubleConv
    decoder: Tuple[int, ...]   # sizes after each Up block's DoubleConv
    output_size: int           # == decoder[-1]
    crops: Tuple[int, ...]     # skip sizes the decoder crops to (upsampled sizes)

    @property
    def margin(self) -> int:
        return self.input_size - self.output_size


def unet_shapes(input_size: int, levels: int = 5) -> UNetShapes:
    """Trace one spatial dimension through the valid-conv U-Net.

    Raises ValueError if any intermediate collapses to < 1 px or a skip
    connection would be smaller than the upsampled map it must be cropped to.
    """
    enc: List[int] = []
    s = input_size
    for lvl in range(levels):
        if lvl > 0:
            s = s // 2  # 2x2 max-pool, floor on odd sizes
        s -= CONV_SHRINK
        if s < 1:
            raise ValueError(
                f"input {input_size}: encoder level {lvl} collapses to {s}px"
            )
        enc.append(s)

    dec: List[int] = []
    crops: List[int] = []
    s = enc[-1]
    for skip in reversed(enc[:-1]):
        s = s * 2  # transposed conv k=2 s=2 (or 2x bilinear)
        if skip < s:
            raise ValueError(
                f"input {input_size}: skip {skip}px smaller than upsampled {s}px"
            )
        crops.append(s)
        s -= CONV_SHRINK
        if s < 1:
            raise ValueError(
                f"input {input_size}: decoder stage collapses to {s}px"
            )
        dec.append(s)

    return UNetShapes(
        input_size=input_size,
        encoder=tuple(enc),
        decoder=tuple(dec),
        output_size=dec[-1],
        crops=tuple(crops),
    )


def output_size(input_size: int, levels: int = 5) -> int:
    return unet_shapes(input_size, levels).output_size


def margin(input_size: int, levels: int = 5) -> int:
    """Total shrinkage input-output (188 at 512, 184 at 572)."""
    sh = unet_shapes(input_size, levels)
    return sh.input_size - sh.output_size


def is_valid_input(input_size: int, levels: int = 5) -> bool:
    try:
        unet_shapes(input_size, levels)
        return True
    except ValueError:
        return False


def min_valid_input(levels: int = 5) -> int:
    """Smallest input size that survives the full encoder/decoder (188 for
    the standard 5-level net — output 4x4)."""
    s = 32
    while not is_valid_input(s, levels):
        s += 1
        if s > 10_000:
            raise RuntimeError("no valid input size found")
    return s


def input_for_output(target_output: int, levels: int = 5) -> int:
    """Smallest valid input whose output is >= target_output. Used by the
    overlap-tile engine to pick tile geometry."""
    s = max(target_output, min_valid_input(levels))
    while True:
        if is_valid_input(s, levels) and output_size(s, levels) >= target_output:
            return s
        s += 1
        if s > 100_000:
            raise RuntimeError("no input size found")


def center_crop_bounds(size: int, target: int) -> Tuple[int, int]:
    """Start/end indices replicating the reference crop
    (reference: models/unet_model.py:88-102): start = max(0, (s-t)//2)."""
    start = max(0, (size - target) // 2)
    return start, start + target
