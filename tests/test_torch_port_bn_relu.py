"""The train step's BatchNorm+ReLU wrappers (ops/kernels/bn_relu.py) on
the CPU: the C entries of csrc/bn_relu.cu are built and bound, the
wrappers are registered launch counters that count nothing on the plain
route, the kernels' row walk (mirrored here) reads every row of the
recipe step's 18 BatchNorms once per channel group and skips a masked
item's rows, and the plain versions' saved buffer and cotangent handling.
The kernels themselves run in tests/test_torch_port_cuda.py on a card.
No jax."""

import re

import numpy as np
import pytest
import torch

from unetseg_tpu_torch.ops import fused_bn
from unetseg_tpu_torch.ops.fused_bn import bn_relu_nhwc
from unetseg_tpu_torch.ops.kernels import bn_relu as BN
from unetseg_tpu_torch.ops.kernels import build
from unetseg_tpu_torch.ops.kernels.launches import launch_counts, reset_launch_counts

SOURCE = build.CSRC / "bn_relu.cu"
# the recipe step's 18 BatchNorms at batch 4 and 512^2: (side of the
# activation, channels), enc0 .. enc4, then dec0 .. dec3
RECIPE_BNS = [(510, 64), (508, 64), (252, 128), (250, 128), (123, 256), (121, 256),
              (58, 512), (56, 512), (26, 1024), (24, 1024), (46, 512), (44, 512),
              (86, 256), (84, 256), (166, 128), (164, 128), (326, 64), (324, 64)]


def test_entries_are_bound_and_the_source_is_built():
    text = SOURCE.read_text()
    entries = set(re.findall(r'extern "C" int (bn_relu\w+)\(', text))
    assert entries == {"bn_relu_stats_bf16", "bn_relu_fwd_finalize_f32", "bn_relu_sums_f32",
                       "bn_relu_apply_bf16", "bn_relu_bwd_stats_bf16",
                       "bn_relu_bwd_finalize_f32", "bn_relu_dz_bf16"}
    assert entries <= set(build.SIGNATURES)
    assert SOURCE in build.sources()


def test_source_constants_match_the_wrappers():
    text = SOURCE.read_text()
    assert f"constexpr int THREADS = {BN.THREADS};" in text
    assert f"constexpr int VEC = {BN.VEC};" in text
    rows = ", ".join(n.upper() for n in BN.SAVED).replace("A,", "A = 0,", 1)
    assert f"enum Saved {{ {rows}, SAVED_ROWS }};" in text
    assert "enum Coef { CA = 0, CS, CQ, COEF_ROWS };" in text and BN.COEF_ROWS == 3
    assert "while (tc < 32 && 2 * tc * VEC <= c) tc *= 2;" in text


def _walk(n_rows, c, hw, mask):
    """Emulate the stats kernel's row walk over every block and thread:
    how often each (row, channel) is read."""
    chunks = BN.plan(n_rows, c)
    tc = BN.lanes(c)
    tr, width = BN.THREADS // tc, tc * BN.VEC
    per = BN.rows_per_chunk(n_rows, c, chunks)
    seen = np.zeros((n_rows, c), np.int64)
    for bx in range(chunks):
        lo, hi = bx * per, min(bx * per + per, n_rows)
        seg = lo
        while seg < hi:
            item = seg // hw
            end = min((item + 1) * hw, hi)
            if mask is None or mask[item]:
                for ty in range(tr):
                    rows = np.arange(seg + ty, end, tr)
                    for by in range(-(-c // width)):
                        for tx in range(tc):
                            ch = (by * tc + tx) * BN.VEC
                            if ch < c:
                                seen[rows[:, None], ch + np.arange(BN.VEC)] += 1
            seg = end
    return seen


@pytest.mark.parametrize("n_rows,c,hw,mask", [
    (7, 64, 7, None), (300, 24, 75, None), (1000, 1024, 250, [True, False, True, False]),
    (97, 128, 97, [False]), (4 * 33, 256, 33, [True, True, False, True]),
], ids=["tiny", "c24", "c1024-masked", "all-masked", "c256-masked"])
def test_walk_reads_each_unmasked_row_once(n_rows, c, hw, mask):
    seen = _walk(n_rows, c, hw, mask)
    want = np.ones(n_rows, np.int64)
    if mask is not None:
        want = np.repeat(np.asarray(mask, np.int64), hw)
    assert (seen == want[:, None]).all()


@pytest.mark.parametrize("side,c", RECIPE_BNS, ids=[f"{s}x{c}" for s, c in RECIPE_BNS])
def test_plan_fills_the_card_at_the_recipe_shapes(side, c):
    """Every chunk has rows, the chunks cover the activation, and the
    blocks (chunks x channel groups) keep each of the 132 SMs busy
    without passing the target by more than a channel group's chunk."""
    n_rows = 4 * side * side
    chunks = BN.plan(n_rows, c)
    per = BN.rows_per_chunk(n_rows, c, chunks)
    tc = BN.lanes(c)
    groups = -(-c // (tc * BN.VEC))
    assert per % (BN.THREADS // tc) == 0
    assert chunks * per >= n_rows > (chunks - 1) * per
    assert 132 <= chunks * groups <= BN.TARGET_BLOCKS + groups
    assert BN.plan(n_rows, c) == chunks  # from (N, C) alone


def _inputs(masked, seed=0, shape=(3, 5, 6, 16)):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(*shape, generator=g)
    c = shape[3]
    gamma, beta = torch.rand(c, generator=g) + 0.5, torch.rand(c, generator=g) - 0.5
    rm, rv = torch.rand(c, generator=g), torch.rand(c, generator=g) + 1.0
    mask = torch.tensor([True, False, True]) if masked else None
    return z, gamma, beta, rm, rv, mask, torch.randn(*shape, generator=g)


@pytest.mark.parametrize("masked", [False, True])
def test_cpu_forward_and_backward_launch_nothing(masked):
    """The wrappers are registered counters; the plain route counts 0."""
    z, gamma, beta, rm, rv, mask, gy = _inputs(masked)
    reset_launch_counts()
    z.requires_grad_(True)
    gamma.requires_grad_(True)
    y, nm, nv = bn_relu_nhwc(z, gamma, beta, rm, rv, 0.9, 1e-5, mask)
    (y * gy).sum().backward()
    counts = launch_counts()
    assert counts["bn_relu_fwd"] == 0 and counts["bn_relu_bwd"] == 0
    assert z.grad.shape == z.shape and torch.isfinite(z.grad).all()


def test_saved_rows_are_the_forward_statistics():
    z, gamma, beta, rm, rv, _, _ = _inputs(False)
    y, nm, nv, saved = BN.bn_relu_fwd_plain(z, gamma, beta, rm, rv, None, 0.9, 1e-5)
    rows = dict(zip(BN.SAVED, saved.unbind(0)))
    zz = z.double().reshape(-1, z.shape[3])
    mean, var = zz.mean(0), zz.var(0, unbiased=False)
    n = zz.shape[0]
    torch.testing.assert_close(rows["mean"].double(), mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rows["var_raw"].double(), var, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rows["inv"].double(), (var + 1e-5).rsqrt(), rtol=1e-5, atol=0)
    torch.testing.assert_close(rows["a"], gamma * rows["inv"])
    torch.testing.assert_close(rows["b"], beta - rows["mean"] * rows["a"])
    assert (rows["n"] == n).all() and torch.allclose(rows["unbias"], torch.full_like(nm, n / (n - 1)))
    torch.testing.assert_close(nv.double(), 0.9 * rv.double() + 0.1 * var * n / (n - 1),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(y, torch.relu(z * rows["a"] + rows["b"]))


@pytest.mark.parametrize("masked", [False, True])
def test_a_missing_cotangent_is_zero(masked):
    """None for a running statistic's cotangent gives what zeros give, and
    None for its gradient; a given one reaches the running statistic."""
    z, gamma, beta, rm, rv, mask, gy = _inputs(masked)
    _, _, _, saved = BN.bn_relu_fwd_plain(z, gamma, beta, rm, rv, mask, 0.9, 1e-5)
    none = BN.bn_relu_bwd_plain(gy, z, gamma, mask, saved, None, None, 0.9)
    zeros = BN.bn_relu_bwd_plain(gy, z, gamma, mask, saved, torch.zeros(16), torch.zeros(16),
                                 0.9)
    for a, b in zip(none[:3], zeros[:3]):
        assert torch.equal(a, b)
    assert none[3] is None and none[4] is None
    ct = torch.linspace(-1, 1, 16)
    given = BN.bn_relu_bwd_plain(gy, z, gamma, mask, saved, ct, 2 * ct, 0.9)
    assert torch.equal(given[3], 0.9 * ct) and torch.equal(given[4], 0.9 * (2 * ct))
    assert not torch.equal(given[0], none[0])  # the cotangents reach dz


def test_running_statistics_take_their_gradient_through_the_function():
    z, gamma, beta, rm, rv, _, _ = _inputs(False)
    rm.requires_grad_(True)
    rv.requires_grad_(True)
    _, nm, nv = bn_relu_nhwc(z, gamma, beta, rm, rv, 0.9, 1e-5)
    (nm.sum() + 3 * nv.sum()).backward()
    torch.testing.assert_close(rm.grad, torch.full_like(rm, 0.9))
    torch.testing.assert_close(rv.grad, torch.full_like(rv, 2.7))


def test_no_host_value_is_copied_to_the_card():
    """The fused BN builds no device tensor from a Python number by a host
    copy (`torch.tensor(..., device=...)`): the unmasked branch's count
    reaches the kernels as a number."""
    for mod in (fused_bn, BN):
        src = open(mod.__file__).read()
        assert "torch.tensor(" not in src, mod.__name__


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """On a device without kernels the wrappers raise, with no fallback;
    the kernels' own checks follow the route."""
    z = torch.zeros(1, 2, 2, 8, device="meta", dtype=torch.bfloat16)
    v = torch.zeros(8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        BN.bn_relu_fwd(z, v, v, v, v)
    with pytest.raises(ValueError, match="different devices"):
        BN.bn_relu_fwd(torch.zeros(1, 2, 2, 8), v, v, v, v)
