"""The default serving forward's kernel wrappers as PyTorch custom operators.

The wrappers reach CUDA through ctypes (ops/kernels/build.py), which a
fake tensor cannot pass through, so `torch.export` cannot trace them as
they are. Registered here in the `unetseg` namespace, each one is an
opaque operator: tracing runs its fake (the output shapes and dtypes of
the wrapper's docstring), and a call runs the counted wrapper itself, so
routing stays by tensor device (a CPU tensor takes the plain version, a
CUDA tensor the kernel or raises) and the launch counters count in eager
and exported runs alike. The pooled form returns two tensors, so it is an
operator of its own:

    torch.ops.unetseg.conv3x3_bias_relu(x, w, b, relu=True)       -> y
    torch.ops.unetseg.conv3x3_bias_relu_pool(x, w, b, relu=True)  -> (y, pooled)
    torch.ops.unetseg.tconv2x2_bias(x, w, b)                      -> y
    torch.ops.unetseg.dec_conv0(skip, up, w, b, row_off, col_off, relu=True) -> y
    torch.ops.unetseg.conv3x3_head(x, w, b, k_head, b_head)       -> f32 logits
    torch.ops.unetseg.attn_gate(skip, g, wx, wg, bg, psi, bpsi, row_off, col_off)
                                                                 -> f32 alpha (B, h, w)
    torch.ops.unetseg.attn_gate_apply(skip, alpha, row_off, col_off) -> x_hat

The last two are the gated net's (ops/kernels/attn_gate.py).

Outputs are contiguous NHWC tensors on either device. Importing this
module registers the operators and builds nothing: a kernel is compiled
at its first launch. Loading an exported artifact needs this module and
nothing else of the package's forward (infer/export.load_exported).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from unetseg_tpu_torch.ops.kernels import attn_gate as G
from unetseg_tpu_torch.ops.kernels import conv3x3 as K

NAMESPACE = "unetseg"
OPS = ("conv3x3_bias_relu", "conv3x3_bias_relu_pool", "tconv2x2_bias", "dec_conv0",
       "conv3x3_head", "attn_gate", "attn_gate_apply")


def _nhwc(x: Tensor, h: int, w: int, c: int, dtype: torch.dtype = None) -> Tensor:
    return x.new_empty((x.shape[0], h, w, c), dtype=dtype or x.dtype)


@torch.library.custom_op(f"{NAMESPACE}::conv3x3_bias_relu", mutates_args=())
def conv3x3_bias_relu(x: Tensor, w: Tensor, b: Tensor, relu: bool = True) -> Tensor:
    return K.conv3x3_bias_relu(x, w, b, relu=relu).contiguous()


@conv3x3_bias_relu.register_fake
def _(x, w, b, relu=True):
    return _nhwc(x, x.shape[1] - 2, x.shape[2] - 2, w.shape[0])


@torch.library.custom_op(f"{NAMESPACE}::conv3x3_bias_relu_pool", mutates_args=())
def conv3x3_bias_relu_pool(x: Tensor, w: Tensor, b: Tensor,
                           relu: bool = True) -> Tuple[Tensor, Tensor]:
    y, pooled = K.conv3x3_bias_relu(x, w, b, fuse_pool=True, relu=relu)
    return y.contiguous(), pooled.contiguous()


@conv3x3_bias_relu_pool.register_fake
def _(x, w, b, relu=True):
    ho, wo, co = x.shape[1] - 2, x.shape[2] - 2, w.shape[0]
    return _nhwc(x, ho, wo, co), _nhwc(x, ho // 2, wo // 2, co)


@torch.library.custom_op(f"{NAMESPACE}::tconv2x2_bias", mutates_args=())
def tconv2x2_bias(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    return K.tconv2x2_bias(x, w, b).contiguous()


@tconv2x2_bias.register_fake
def _(x, w, b):
    return _nhwc(x, 2 * x.shape[1], 2 * x.shape[2], w.shape[1])


@torch.library.custom_op(f"{NAMESPACE}::dec_conv0", mutates_args=())
def dec_conv0(skip: Tensor, up: Tensor, w: Tensor, b: Tensor, row_off: int, col_off: int,
              relu: bool = True) -> Tensor:
    return K.dec_conv0(skip, up, w, b, row_off, col_off, relu=relu).contiguous()


@dec_conv0.register_fake
def _(skip, up, w, b, row_off, col_off, relu=True):
    return _nhwc(up, up.shape[1] - 2, up.shape[2] - 2, w.shape[0])


@torch.library.custom_op(f"{NAMESPACE}::conv3x3_head", mutates_args=())
def conv3x3_head(x: Tensor, w: Tensor, b: Tensor, k_head: Tensor, b_head: Tensor) -> Tensor:
    return K.conv3x3_head(x, w, b, k_head, b_head).contiguous()


@conv3x3_head.register_fake
def _(x, w, b, k_head, b_head):
    return _nhwc(x, x.shape[1] - 2, x.shape[2] - 2, k_head.shape[0], torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::attn_gate", mutates_args=())
def attn_gate(skip: Tensor, g: Tensor, wx: Tensor, wg: Tensor, bg: Tensor, psi: Tensor,
              bpsi: Tensor, row_off: int, col_off: int) -> Tensor:
    return G.attn_gate(skip, g, wx, wg, bg, psi, bpsi, row_off, col_off).contiguous()


@attn_gate.register_fake
def _(skip, g, wx, wg, bg, psi, bpsi, row_off, col_off):
    return g.new_empty((g.shape[0], g.shape[1], g.shape[2]), dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::attn_gate_apply", mutates_args=())
def attn_gate_apply(skip: Tensor, alpha: Tensor, row_off: int, col_off: int) -> Tensor:
    return G.attn_gate_apply(skip, alpha, row_off, col_off).contiguous()


@attn_gate_apply.register_fake
def _(skip, alpha, row_off, col_off):
    return _nhwc(skip, 2 * alpha.shape[1], 2 * alpha.shape[2], skip.shape[3])
