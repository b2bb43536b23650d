"""What every architecture's plain reference shares: float32 without TF32,
the variables' tree flattened to float32 arrays, the centre crop. Plain
PyTorch and numpy; imports nothing of the program.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


def exact_f32() -> None:
    """Float32 matrix products and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def flat(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested tree of arrays -> {'a/b/leaf': float32 array}, in the
    tree's order."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def centre_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    top = (x.shape[-2] - size) // 2
    left = (x.shape[-1] - size) // 2
    return x[..., top:top + size, left:left + size]
