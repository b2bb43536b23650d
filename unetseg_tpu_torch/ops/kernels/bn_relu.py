"""Train-mode BatchNorm+ReLU over an NHWC activation: the plain versions,
the wrappers of csrc/bn_relu.cu and their launch counters.

No TPU kernel is replaced: the JAX package's make_bn_relu_nhwc
(unetseg_tpu/ops/fused_bn.py) is a custom VJP in XLA. The plain versions
are the port's fused BN in PyTorch (the same function as
models/unet.masked_batch_norm followed by ReLU): every reduction in f32,
the elementwise work in the activation's dtype with bf16-rounded
coefficients, some 30 operator calls a BatchNorm. On the card
`bn_relu_fwd` and `bn_relu_bwd` each launch three kernels (statistics,
finalise, the elementwise pass) that compute the same formulas with f32
coefficients and one rounding at the store. Routing as in
ops/kernels/conv3x3.py: a CPU tensor runs the plain version, a CUDA tensor
the kernels or a raise.

Both routes hand the backward the same per-channel f32 buffer `saved`
(SAVED rows: a = gamma / sqrt(var + eps), b = beta - mean a, the mean,
1 / sqrt(var + eps), the unclamped variance, the count n and the
unbiasing factor), so ops/fused_bn.BnReluNHWC saves one tensor for
either. With a process `group` the forward sums (s, sq, n) over the ranks
before the mean and variance, and the backward sums the statistics'
cotangents (G1, G2 and those of the running statistics) before dz; dgamma
and dbeta stay this rank's contributions.

The kernels' block shapes follow (N, C) alone (`plan`): a block's 256
threads own 8 channels each, up to 32 across the channels and the rest
down the rows; blocks take row chunks x channel groups, some 4 an SM on
the 132 SMs. The chunks' partial sums are added in a fixed order, so the
same inputs give the same bits on every run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from unetseg_tpu_torch.core.distributed import all_reduce_cat, all_reduce_sum
from unetseg_tpu_torch.ops.kernels.build import library
from unetseg_tpu_torch.ops.kernels.conv3x3 import _f32, _on_cpu, _raise_on, _stream
from unetseg_tpu_torch.ops.kernels.launches import counted

SAVED = ("a", "b", "mean", "inv", "var_raw", "n", "unbias")  # rows of `saved`
THREADS, VEC = 256, 8     # a pass's block, channels a thread owns (csrc/bn_relu.cu)
TARGET_BLOCKS = 4 * 132   # blocks of a pass: some 4 on each of the H100's SMs
COEF_ROWS = 3             # the dz coefficients: a, ds, 2 dsq


def lanes(c: int) -> int:
    """Threads of a block across the channels: the largest power of two up
    to 32 whose 8-channel slices fit in c (csrc/bn_relu.cu lanes_of)."""
    tc = 1
    while tc < 32 and 2 * tc * VEC <= c:
        tc *= 2
    return tc


def plan(n_rows: int, c: int) -> int:
    """The row chunks of the passes over an (n_rows, c) activation: about
    TARGET_BLOCKS blocks, no more chunks than a block has rows to take and
    none empty once a chunk's rows are rounded up to a block's rows at a
    time (csrc/bn_relu.cu `plan` rounds them so from the count)."""
    tc = lanes(c)
    groups = -(-c // (tc * VEC))
    want = max(1, min(-(-TARGET_BLOCKS // groups), -(-n_rows // (THREADS // tc))))
    return -(-n_rows // rows_per_chunk(n_rows, c, want))


def rows_per_chunk(n_rows: int, c: int, chunks: int) -> int:
    """A chunk's rows as the kernels take them from the chunk count: a
    multiple of the rows a block takes at a time."""
    tr = THREADS // lanes(c)
    return -(-(-(-n_rows // chunks)) // tr) * tr


def _tie(x: torch.Tensor) -> torch.Tensor:
    """Gradient factor of max(x, 0): 1 above 0, 0.5 at 0, 0 below (f32)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, 0.0, 0.5)).float()


# ------------------------------------------------------------ plain versions
def bn_relu_fwd_plain(z, gamma, beta, run_mean, run_var, item_mask=None, momentum=0.9,
                      eps=1e-5, group=None):
    """-> (y, new running mean, new running var, saved)."""
    b, h, w, c = z.shape
    dims = (0, 1, 2)
    if item_mask is not None:
        wm = item_mask.to(z.dtype)[:, None, None, None]
        s = (z * wm).sum(dims, dtype=torch.float32)
        sq = (z.square() * wm).sum(dims, dtype=torch.float32)
        n = item_mask.float().sum() * (h * w)
    else:
        s = z.sum(dims, dtype=torch.float32)
        sq = z.square().sum(dims, dtype=torch.float32)
        n = torch.full((), float(b * h * w), device=z.device)
    if group is not None:
        s, sq, n = all_reduce_cat(group, s, sq, n)
    n = n.clamp_min(1.0)
    mean = s / n
    var_raw = sq / n - mean.square()
    var = var_raw.clamp_min(0.0)
    unbias = n / (n - 1.0).clamp_min(1.0)
    new_mean = momentum * run_mean + (1 - momentum) * mean
    new_var = momentum * run_var + (1 - momentum) * var * unbias
    inv = torch.rsqrt(var + eps)
    a = gamma * inv
    bb = beta - mean * a
    y = torch.addcmul(bb.to(z.dtype), z, a.to(z.dtype)).clamp_min_(0)
    saved = torch.stack([a, bb, mean, inv, var_raw, n.expand(c), unbias.expand(c)])
    return y, new_mean, new_var, saved


def bn_relu_bwd_plain(gy, z, gamma, item_mask, saved, ct_mean=None, ct_var=None,
                      momentum=0.9, group=None):
    """-> (dz, dgamma, dbeta, d run mean, d run var); the last two None
    where their cotangent is None (taken as zero)."""
    a, bb, mean, inv, var_raw, n, unbias = saved.unbind(0)
    mom, dt = momentum, z.dtype
    gp = gy * _tie(torch.addcmul(bb.to(dt), z, a.to(dt))).to(gy.dtype)
    dims = (0, 1, 2)
    g1 = (gp * z).sum(dims, dtype=torch.float32)
    g2 = gp.sum(dims, dtype=torch.float32)
    da = g1 - mean * g2
    dgamma, dbeta = da * inv, g2
    d_run = tuple(None if ct is None else mom * ct for ct in (ct_mean, ct_var))
    ct_mean = torch.zeros_like(mean) if ct_mean is None else ct_mean
    ct_var = torch.zeros_like(mean) if ct_var is None else ct_var
    if group is not None:  # the statistics' cotangents from every rank
        g1, g2, ct_mean, ct_var = all_reduce_cat(group, g1, g2, ct_mean, ct_var)
        da = g1 - mean * g2
    dvar = -0.5 * inv.pow(3) * (gamma * da)
    dvar = (dvar + (1 - mom) * unbias * ct_var) * _tie(var_raw)
    dmean = -a * g2 + (1 - mom) * ct_mean - 2.0 * mean * dvar
    ds, dsq = dmean / n, dvar / n
    stat = torch.addcmul(ds.to(dt), z, (2.0 * dsq).to(dt))
    if item_mask is not None:
        stat = stat * item_mask.to(dt)[:, None, None, None]
    dz = torch.addcmul(stat, gp, a.to(dt))
    return dz, dgamma, dbeta, *d_run


# ------------------------------------------------------------------ wrappers
def _check(wrapper, z: torch.Tensor, *vectors: torch.Tensor) -> torch.Tensor:
    """z as a contiguous bf16 NHWC tensor (counted in `wrapper.restrided`
    when it had to be copied); raises on what the kernels do not take."""
    name = wrapper.__name__
    if z.dtype != torch.bfloat16 or z.dim() != 4:
        raise TypeError(f"{name}: kernels take a bfloat16 NHWC tensor, got {z.dtype} "
                        f"{tuple(z.shape)}")
    c = z.shape[3]
    if c % VEC:
        raise ValueError(f"{name}: channels {c} not a multiple of {VEC}")
    if any(tuple(v.shape) != (c,) for v in vectors):
        raise ValueError(f"{name}: per-channel vectors {[tuple(v.shape) for v in vectors]} "
                         f"for {c} channels")
    if not z.is_contiguous():
        z = z.contiguous()
        wrapper.restrided += 1
    return z


def _mask(item_mask: Optional[torch.Tensor], b: int):
    """(pointer or None, the uint8 tensor to keep alive) of a (B,) item mask."""
    if item_mask is None:
        return None, None
    if tuple(item_mask.shape) != (b,):
        raise ValueError(f"item_mask {tuple(item_mask.shape)} for a batch of {b}")
    m = (item_mask if item_mask.dtype == torch.bool else item_mask != 0).contiguous()
    m = m.view(torch.uint8)
    return m.data_ptr(), m


def _present(t: Optional[torch.Tensor]) -> tuple:
    return () if t is None else (t,)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _sums(lib, part: torch.Tensor, stream: int) -> torch.Tensor:
    """A rank's (2, C) sums of its (2, chunks, C) partials, in the order the
    finalise kernel adds them: a group's sums then match one process's bit
    for bit where every rank holds the same items."""
    out = torch.empty(2, part.shape[2], dtype=torch.float32, device=part.device)
    _raise_on(lib.bn_relu_sums_f32(part.data_ptr(), part.shape[1], part.shape[2],
                                   out.data_ptr(), stream), "bn_relu sums")
    return out


@counted
def bn_relu_fwd(z: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                run_mean: torch.Tensor, run_var: torch.Tensor,
                item_mask: Optional[torch.Tensor] = None, momentum: float = 0.9,
                eps: float = 1e-5, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm+ReLU of z (B, H, W, C) -> (y, new running mean,
    new running var, saved); item_mask (B,) leaves masked items out of the
    statistics. One count per call of the three launches (four with a
    group)."""
    if _on_cpu(z, gamma, beta, run_mean, run_var, *_present(item_mask)):
        return bn_relu_fwd_plain(z, gamma, beta, run_mean, run_var, item_mask, momentum, eps,
                                 group)
    z = _check(bn_relu_fwd, z, gamma, beta, run_mean, run_var)
    b, h, w, c = z.shape
    n_rows, hw, dev = b * h * w, h * w, z.device
    mask, keep = _mask(item_mask, b)
    chunks, stream, lib = plan(n_rows, c), _stream(z), library()
    part = torch.empty(2, chunks, c, dtype=torch.float32, device=dev)
    _raise_on(lib.bn_relu_stats_bf16(z.data_ptr(), mask, n_rows, c, hw, chunks,
                                     part.data_ptr(), stream), "bn_relu_fwd")
    fin, fin_chunks, n_dev = part, chunks, None
    if group is not None:  # the moments of the group's batch: (s, sq, n) summed
        n = (keep.float().sum() * hw if keep is not None
             else torch.full((), float(n_rows), device=dev))
        flat = all_reduce_sum(torch.cat([_sums(lib, part, stream).reshape(-1), n.reshape(1)]),
                              group)
        fin, fin_chunks, n_dev = flat[:2 * c].view(2, 1, c), 1, flat[2 * c:]
    gamma, beta, run_mean, run_var = (_f32(t) for t in (gamma, beta, run_mean, run_var))
    new_mean = torch.empty(c, dtype=torch.float32, device=dev)
    new_var = torch.empty_like(new_mean)
    saved = torch.empty(len(SAVED), c, dtype=torch.float32, device=dev)
    _raise_on(lib.bn_relu_fwd_finalize_f32(
        fin.data_ptr(), fin_chunks, c, _ptr(n_dev), mask, b, hw, float(n_rows),
        gamma.data_ptr(), beta.data_ptr(), run_mean.data_ptr(), run_var.data_ptr(), momentum,
        1 - momentum, eps, new_mean.data_ptr(), new_var.data_ptr(), saved.data_ptr(), stream),
        "bn_relu_fwd")
    y = torch.empty_like(z)
    _raise_on(lib.bn_relu_apply_bf16(z.data_ptr(), n_rows, c, chunks, saved.data_ptr(),
                                     y.data_ptr(), stream), "bn_relu_fwd")
    bn_relu_fwd.launches += 1
    return y, new_mean, new_var, saved


@counted
def bn_relu_bwd(gy: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor,
                item_mask: Optional[torch.Tensor], saved: torch.Tensor,
                ct_mean: Optional[torch.Tensor] = None, ct_var: Optional[torch.Tensor] = None,
                momentum: float = 0.9, group=None):
    """The backward of `bn_relu_fwd` from its `saved` -> (dz, dgamma, dbeta,
    d run mean, d run var); a running statistic's cotangent may be None
    (zero), and then so is its gradient. One count per call of the three
    launches (four with a group)."""
    if _on_cpu(gy, z, gamma, saved, *_present(item_mask)):
        return bn_relu_bwd_plain(gy, z, gamma, item_mask, saved, ct_mean, ct_var, momentum,
                                 group)
    z = _check(bn_relu_bwd, z, gamma)
    gy = _check(bn_relu_bwd, gy)
    if gy.shape != z.shape or tuple(saved.shape) != (len(SAVED), z.shape[3]):
        raise ValueError(f"bn_relu_bwd: gy {tuple(gy.shape)}, z {tuple(z.shape)}, saved "
                         f"{tuple(saved.shape)}")
    b, h, w, c = z.shape
    n_rows, hw, dev = b * h * w, h * w, z.device
    mask, keep = _mask(item_mask, b)
    chunks, stream, lib = plan(n_rows, c), _stream(z), library()
    saved = _f32(saved)
    part = torch.empty(2, chunks, c, dtype=torch.float32, device=dev)
    _raise_on(lib.bn_relu_bwd_stats_bf16(gy.data_ptr(), z.data_ptr(), n_rows, c, chunks,
                                         saved.data_ptr(), part.data_ptr(), stream),
              "bn_relu_bwd")
    ct_mean, ct_var = (None if ct is None else _f32(ct) for ct in (ct_mean, ct_var))
    fin, fin_chunks, glob = part, chunks, None
    if group is not None:  # the statistics' cotangents from every rank
        fin, fin_chunks = _sums(lib, part, stream).view(2, 1, c), 1
        zero = torch.zeros(c, dtype=torch.float32, device=dev)
        glob = all_reduce_sum(torch.cat([fin.reshape(-1), zero if ct_mean is None else ct_mean,
                                         zero if ct_var is None else ct_var]), group)
    vec = lambda: torch.empty(c, dtype=torch.float32, device=dev)  # noqa: E731
    dgamma, dbeta = vec(), vec()
    d_mean = None if ct_mean is None else vec()
    d_var = None if ct_var is None else vec()
    coef = torch.empty(COEF_ROWS, c, dtype=torch.float32, device=dev)
    _raise_on(lib.bn_relu_bwd_finalize_f32(
        fin.data_ptr(), fin_chunks, c, _ptr(glob), _ptr(ct_mean), _ptr(ct_var),
        saved.data_ptr(), _f32(gamma).data_ptr(), momentum, 1 - momentum, dgamma.data_ptr(),
        dbeta.data_ptr(), _ptr(d_mean), _ptr(d_var), coef.data_ptr(), stream), "bn_relu_bwd")
    dz = torch.empty_like(z)
    _raise_on(lib.bn_relu_dz_bf16(gy.data_ptr(), z.data_ptr(), mask, n_rows, c, hw, chunks,
                                  saved.data_ptr(), coef.data_ptr(), dz.data_ptr(), stream),
              "bn_relu_bwd")
    bn_relu_bwd.launches += 1
    return dz, dgamma, dbeta, d_mean, d_var


bn_relu_fwd.restrided = 0
bn_relu_bwd.restrided = 0
