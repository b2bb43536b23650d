"""Instance boundary refinement: grow labels into background (a copy of
unetseg_tpu/post/boundary.py).

Round-5 finding (tools/boundary_sweep.py over the shipped flagship80
masks): the flagship's vote merges (member-vote x flip-vote) erode
membranes — a boundary ring only survives where a majority of members and
flips agree, which systematically shrinks instances. Growing every
instance up to `radius` px into BACKGROUND ONLY (nearest-label assignment;
labels never overwrite other labels, so the membrane between touching
cells stays put and the vote's separation win survives) recovers it:

    seq 01 grow 1.0: SEG 0.8863->0.8865, TRA 0.9516->0.9555, DET ->0.9600
    seq 02 grow 1.5: SEG 0.8466->0.8533, TRA 0.8916->0.8979, DET ->0.9062
    (divisions 8/8 + 5/5 at both; larger radii over-grow: seq-01 SEG
    0.8837 @ 1.5, 0.8785 @ 2.0 — the optimum is sequence-dependent, hence
    InferConfig.boundary_grow + the per-sequence recipe override.)

The round-7 error budget said seq-02's residual SEG loss was boundary
quality on found cells (not FN/FP) — this is the lever that cashes it.
reference scope: scripts/predict.py:84-112 writes raw CC instances with no
boundary post-processing at all.
"""

from __future__ import annotations

import numpy as np


def grow_instances(mask: np.ndarray, radius: float) -> np.ndarray:
    """Grow every labeled instance up to `radius` px into background.

    Background pixels within `radius` (Euclidean) of any instance adopt the
    label of their NEAREST instance pixel; labeled pixels are never
    rewritten, so instances cannot absorb each other and the inter-cell
    membrane geometry is preserved. radius <= 0 is the identity.
    """
    if radius <= 0:
        return mask
    from scipy.ndimage import distance_transform_edt

    bg = mask == 0
    dist, (iy, ix) = distance_transform_edt(bg, return_indices=True)
    out = mask.copy()
    sel = bg & (dist <= radius)
    out[sel] = mask[iy[sel], ix[sel]]
    return out
