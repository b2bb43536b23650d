"""Serving export (counterpart of unetseg_tpu/infer/export.py): the
one-member serving function through `torch.export` into a self-contained
artifact.

- The exported function is infer/serving.ServingFn: `(b, S, S)` f32 in
  [0, 1] -> what `Predictor.probs` computes for one member, the
  normalisation or standardisation baked in; softmax for a 3-class head.
- Weights are baked in. Loading needs torch and ops/kernels/library.py
  (the custom operators the graph names), and no checkpoint, Predictor
  or training code.
- The batch axis is symbolic by default (`b`), so one artifact serves
  any batch; an int pins it.
- The forward is the default kernel forward (torch.ops.unetseg.*) where
  infer/kernel_net.supports holds on the export device and on every
  platform the artifact names, else the plain folded net. The serving
  variants' options are not exported: the JAX export exports its plain
  folded forward only.
- `platforms` names the devices the artifact is for ("cuda" and "cpu" by
  default). They are stored in the archive, and load_exported moves the
  program to a named device or refuses one that is not named.

The overlap-tile driver (infer/tiling.py) is host geometry; a server runs
it unchanged around the exported tile function.
"""

from __future__ import annotations

import io
from typing import Any, Callable, Mapping, Optional, Sequence, Union

import torch

from unetseg_tpu_torch.core.config import InferConfig, ModelConfig

PLATFORMS = ("cuda", "cpu")
PLATFORMS_FILE = "unetseg_platforms"  # the archive's extra file that lists them
EXAMPLE_BATCH = 2  # traced batch of a symbolic export (0 and 1 would specialise)


def make_serving_fn(
    model_cfg: ModelConfig,
    variables: Mapping[str, Any],
    infer_cfg: Optional[InferConfig] = None,
    device: Union[str, torch.device] = "cuda",
    platforms: Sequence[str] = (),
) -> torch.nn.Module:
    """The serving module of one member on `device`: BatchNorm folded, the
    kernel forward where supports() holds on `device` and on each of
    `platforms`, else the plain folded net."""
    from unetseg_tpu_torch.infer.folding import fold_batchnorm
    from unetseg_tpu_torch.infer.kernel_net import supports
    from unetseg_tpu_torch.infer.serving import ServingFn
    from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict

    device = torch.device(device)
    kernels = all(supports(model_cfg, torch.device(d)) for d in (device, *platforms))
    net = fold_batchnorm(model_cfg, flax_to_state_dict(variables)).to(device)
    return ServingFn(net, infer_cfg or InferConfig(), kernels).eval()


def export_inference(
    model_cfg: ModelConfig,
    variables: Mapping[str, Any],
    infer_cfg: Optional[InferConfig] = None,
    image_size: Optional[int] = None,
    batch: Optional[int] = None,
    platforms: Sequence[str] = PLATFORMS,
    device: Union[str, torch.device] = "cuda",
) -> bytes:
    """The serving function traced on `device` and serialised to bytes.
    batch=None exports a symbolic batch dimension; an int pins it."""
    infer_cfg = infer_cfg or InferConfig()
    platforms = _check_platforms(platforms)
    serve = make_serving_fn(model_cfg, variables, infer_cfg, device, platforms)
    size = image_size or infer_cfg.image_size
    example = torch.zeros((batch or EXAMPLE_BATCH, size, size), device=device)
    shapes = None if batch is not None else {"images": {0: torch.export.Dim("b")}}
    with torch.no_grad():
        exported = torch.export.export(serve, (example,), dynamic_shapes=shapes)
    buf = io.BytesIO()
    torch.export.save(exported, buf, extra_files={PLATFORMS_FILE: ",".join(platforms)})
    return buf.getvalue()


def save_exported(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def load_exported(path: str, device: Union[str, torch.device, None] = None) -> Callable:
    """Read an artifact -> callable `(images) -> probs` on the program's
    device (images are moved there), with `.exported`
    (the torch.export.ExportedProgram) and `.platforms`. `device` moves the
    program to a device its platforms name (a ValueError for any other);
    None keeps the device it was exported on. Imports the custom
    operators and nothing else of the package's forward."""
    from unetseg_tpu_torch.ops.kernels import library  # noqa: F401  (the graph's operators)

    extra = {PLATFORMS_FILE: ""}
    exported = torch.export.load(path, extra_files=extra)
    platforms = tuple(p for p in extra[PLATFORMS_FILE].split(",") if p)
    if device is not None:
        device = torch.device(device)
        if device.type not in platforms:
            raise ValueError(f"{path} is exported for {','.join(platforms)}, not {device.type}")
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    module = exported.module()
    where = next(iter(exported.state_dict.values())).device

    def call(images) -> torch.Tensor:
        with torch.no_grad():
            return module(torch.as_tensor(images, dtype=torch.float32, device=where))

    call.exported = exported
    call.platforms = platforms
    return call


def _check_platforms(platforms: Sequence[str]) -> tuple:
    out = tuple(platforms)
    unknown = [p for p in out if p not in PLATFORMS]
    if not out or unknown:
        raise ValueError(f"platforms {list(out)}; expected some of {list(PLATFORMS)}")
    return out
