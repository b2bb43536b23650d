"""The fused enc0 (enc0_fused_kernel of csrc/conv_fwd_wgmma.cu) as
ops/kernels/conv3x3.py mirrors it, on the CPU: its band walk against every
skip0 and pooled pixel, its shared memory and the serving plan, the
source's constants against the mirror's, every C entry's ctypes signature
against its declaration, and an emulation of the walk (per step the flat x
rows the kernel copies, the stem into a NaN-filled h tile of two, conv1 tap
by tap from it, the pool of the rounded values) against enc0_fused_plain.
The kernel itself is held bit for bit to the chained kernels by
tests/test_torch_port_cuda.py on the card. No jax.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unetseg_tpu_torch.ops.kernels import build
from unetseg_tpu_torch.ops.kernels import conv3x3 as K

SMS = 132  # an H100 SXM's SMs
PITCH = K.ENC0_STEP + 2  # h pixels a row of the tile


def _bf16_values(rs, *shape, scale=1.0):
    a = torch.from_numpy(rs.standard_normal(shape).astype(np.float32) * scale)
    return a.to(torch.bfloat16).float()


@pytest.mark.parametrize("b,ho,wo,sms", [
    (16, 696, 696, SMS),  # the serving shape: 30,624 steps, 232 a block
    (2, 3, 5, SMS),       # Ho < 32 and Wo < 8: one step an image, the pool one row
    (3, 71, 66, SMS),     # three bands (the last 7 rows), 81 steps on 81 blocks
    (1, 97, 33, 5),       # four bands (the last one row), 20 steps on 5 blocks
    (2, 192, 196, SMS),   # 300 steps: blocks of two or three across band and image seams
    (1, 1, 1, 7),         # one skip0 pixel, no pooled pixel: more blocks than steps
    (2, 8, 9, 3),         # odd Wo under the pool
])
def test_enc0_steps_cover_every_pixel_once(b, ho, wo, sms):
    """The blocks' contiguous step ranges partition the (image, band,
    column step) steps in order, and the steps store every skip0 pixel
    and every pooled pixel exactly once."""
    plan = K.enc0_fused_plan(b, ho, wo, sms)
    walk = K.enc0_fused_steps(plan)
    assert len(walk) == plan.grid == min(plan.steps, sms)
    order = np.concatenate(walk)
    assert all(len(rows) > 0 for rows in walk)
    t = (order[:, 0] * plan.nbands + order[:, 1]) * plan.nj + order[:, 2]
    assert np.array_equal(t, np.arange(plan.steps))
    for rows in walk:  # a carry follows the same band's column step j - 1
        for i, (bi, band, j, carry) in enumerate(rows):
            assert carry == (i > 0 and j > 0)
            if carry:
                assert tuple(rows[i - 1][:3]) == (bi, band, j - 1)
    seen = np.zeros((b, ho, wo), np.int32)
    pseen = np.zeros((b, ho // 2, wo // 2), np.int32)
    for bi, band, j, _ in order:
        y0, x0 = band * K.ENC0_OUT, j * K.ENC0_STEP
        seen[bi, y0:y0 + K.ENC0_OUT, x0:x0 + K.ENC0_STEP] += 1
        pseen[bi, y0 // 2:(y0 + K.ENC0_OUT) // 2, x0 // 2:(x0 + K.ENC0_STEP) // 2] += 1
    assert (seen == 1).all() and (pseen == 1).all()


def test_enc0_serving_plan_and_shared_memory():
    """At the serving shape (16 x 700^2 -> 16 x 696^2 x 64): 22 bands of 87
    column steps, 30,624 steps on one block per SM; conv1 computes 704
    rows for 696 (fill above 0.98); the stem computes 36 rows of 10 pixels
    a step where it does not carry and of 8 where it does, 1.13x the 698^2
    pixels conv1 reads; the block's shared memory fits the 227 KB."""
    plan = K.enc0_fused_plan(16, 696, 696, SMS)
    assert (plan.nbands, plan.nj, plan.steps, plan.grid) == (22, 87, 30624, SMS)
    assert plan.fill > 0.98 and plan.fill == pytest.approx(696 / 704)
    fresh = 16 * 22 + SMS - sum(1 for blk in range(SMS) if 30624 * blk // SMS % 87 == 0)
    assert plan.recompute == pytest.approx(
        36 * (fresh * 10 + (30624 - fresh) * 8) / (16 * 698 * 698))
    assert 1.12 < plan.recompute < 1.14
    assert plan.smem == K.enc0_fused_smem_bytes() <= K.SMEM_PER_BLOCK
    # a step's stem rows cover the E0_OUT + 2 that conv1 reads (its units:
    # ENC0_NSEG segments of 8 or 10 columns, two or three a unit lane of
    # 16), and its x rows the rows they read
    assert K.ENC0_H_ROWS == K.ENC0_NSEG * K.ENC0_SEG >= K.ENC0_OUT + 2
    assert K.ENC0_NSEG * K.ENC0_STEP == 2 * 16 and K.ENC0_NSEG * PITCH <= 3 * 16
    assert K.ENC0_X_ROWS == K.ENC0_H_ROWS + 2
    # a row's 16-byte loads cover its values from the 16-byte boundary
    # before them, a load a stem thread
    assert 8 * K.ENC0_X_CHUNKS >= 7 + PITCH + 2 and 16 * K.ENC0_X_CHUNKS <= K.ENC0_X_ROW
    assert K.ENC0_X_ROWS * K.ENC0_X_CHUNKS <= 128


def test_enc0_constants_match_the_source():
    """The mirror's constants are the kernel's."""
    text = (build.CSRC / "conv_fwd_wgmma.cu").read_text()
    assert f"constexpr int E0_OUT = {K.ENC0_OUT}, E0_STEP = UNIT;" in text
    assert f"constexpr int UNIT = {K.ENC0_STEP};" in text
    assert "TB_PITCH = TB_STEP + 2" in text and "TB_STEP = UNIT" in text
    assert f"constexpr int E0_SEG = {K.ENC0_SEG}, E0_NSEG = {K.ENC0_NSEG};" in text
    assert "constexpr int E0_H_ROWS = E0_NSEG * E0_SEG;" in text
    assert "constexpr int E0_XROWS = E0_H_ROWS + 2;" in text
    assert f"constexpr int E0_X_CHUNKS = {K.ENC0_X_CHUNKS};" in text
    assert f"constexpr int E0_X_ROW = {K.ENC0_X_ROW};" in text


def _c_entries():
    """{name: [parameter C types]} of every C entry of csrc/*.cu."""
    entries = {}
    for src in build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            params = [" ".join(p.split()) for p in params.split(",") if p.strip()]
            entries[name] = [re.sub(r"\s*\b\w+$", "", p) for p in params]
    return entries


C_ENTRIES = _c_entries()


def test_c_entries_match_the_signatures():
    """Every C entry of csrc/*.cu has a ctypes signature in build.py with
    as many arguments, and every signature names an entry."""
    assert set(C_ENTRIES) == set(build.SIGNATURES)
    for name, params in C_ENTRIES.items():
        assert len(build.SIGNATURES[name]) == len(params), name


def _ctype(c_type):
    """The ctypes class that passes a C parameter type."""
    if c_type.endswith("*"):
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}[c_type]


@pytest.mark.parametrize("entry", sorted(C_ENTRIES))
def test_c_entry_argument_types(entry):
    """Each parameter of a C entry, in order, has the ctypes class that
    passes its C type in build.py's signature (a pointer c_void_p, int
    c_int, long long c_longlong, float c_float): a swapped int and long
    long or a float passed as an int would reach the kernel as garbage."""
    assert build.SIGNATURES[entry] == [_ctype(c) for c in C_ENTRIES[entry]]


def test_enc0_fused_runs_plain_on_cpu_uncounted():
    """On CPU tensors enc0_fused runs its plain version without counting a
    launch."""
    rs = np.random.RandomState(0)
    x = _bf16_values(rs, 1, 9, 9, 1)
    w0, b0 = _bf16_values(rs, 64, 1, 3, 3), _bf16_values(rs, 64)
    w1, b1 = _bf16_values(rs, 64, 64, 3, 3, scale=0.05), _bf16_values(rs, 64)
    K.reset_launch_counts()
    skip, pooled = K.enc0_fused(x, w0, b0, w1, b1)
    assert K.launch_counts()["enc0_fused"] == 0
    assert skip.shape == (1, 5, 5, 64) and pooled.shape == (1, 2, 2, 64)


def _x_rows(flat, row0, w):
    """The kernel's staged x of a step as (ENC0_X_ROWS, PITCH + 2) values:
    row r holds the flat input from row0 + r w on (its loads start at the
    16-byte boundary at or before that index, and the stem reads from its
    offset in them: the same values), zeros past the input's end. Past an
    image row's end it reads the next row."""
    first = row0 + np.arange(K.ENC0_X_ROWS) * w
    assert ((first & 7) + PITCH + 2 <= 8 * K.ENC0_X_CHUNKS).all()  # inside the row's loads
    idx = first[:, None] + np.arange(PITCH + 2)[None, :]
    out = torch.zeros(idx.shape)
    ok = idx < flat.numel()
    out[torch.from_numpy(ok)] = flat[torch.from_numpy(idx[ok])]
    return out


def _enc0_emulation(x, w0, b0, w1, b1, sms, rnd):
    """The kernel's walk on the same values: per block two h tiles of
    ENC0_H_ROWS rows x PITCH pixels holding NaN (shared memory never
    written); per step into tile k & 1 the carry (columns 0, 1 from the
    other tile's 8, 9) where the walk says so, and the stem's ENC0_H_ROWS
    rows of the other columns from the step's staged x rows,
    `rnd`-rounded; conv1 + bias + ReLU tap by tap from the tile's first
    ENC0_OUT + 2 rows, `rnd`-rounded; each warpgroup's 2x2 pool of the
    rounded values; the valid part of both stored."""
    bsz, h, w, _ = x.shape
    ho, wo = h - 4, w - 4
    flat = x.reshape(-1)
    skip = torch.full((bsz, ho, wo, 64), float("nan"))
    pooled = torch.full((bsz, ho // 2, wo // 2, 64), float("nan"))
    plan = K.enc0_fused_plan(bsz, ho, wo, sms)
    rows = K.ENC0_OUT + 2
    for walk in K.enc0_fused_steps(plan):
        tiles = [torch.full((64, K.ENC0_H_ROWS, PITCH), float("nan")) for _ in range(2)]
        for k, (bi, band, j, carry) in enumerate(walk):
            y0, x0 = band * K.ENC0_OUT, j * K.ENC0_STEP
            xs = _x_rows(flat, (bi * h + y0) * w + x0, w)
            stem = rnd(F.relu(F.conv2d(xs[None, None], w0, b0)[0]))  # (64, X_ROWS - 2, PITCH)
            c0 = 2 if carry else 0
            if carry:
                tiles[k & 1][:, :, :2] = tiles[(k - 1) & 1][:, :, K.ENC0_STEP:]
            tiles[k & 1][:, :, c0:] = stem[:, :, c0:]
            ht = tiles[k & 1][:, :rows]
            acc = torch.zeros(64, K.ENC0_OUT, K.ENC0_STEP)
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                acc += torch.einsum("oc,crs->ors", w1[:, :, ky, kx],
                                    ht[:, ky:ky + K.ENC0_OUT, kx:kx + K.ENC0_STEP])
            out = rnd(F.relu(acc + b1[:, None, None]))  # (64, ENC0_OUT, ENC0_STEP)
            pool = torch.cat([F.max_pool2d(out[None, :, :16], 2)[0],
                              F.max_pool2d(out[None, :, 16:], 2)[0]], dim=1)
            ny, nx = min(K.ENC0_OUT, ho - y0), min(K.ENC0_STEP, wo - x0)
            assert torch.isnan(skip[bi, y0:y0 + ny, x0:x0 + nx]).all()  # stored once
            skip[bi, y0:y0 + ny, x0:x0 + nx] = out[:, :ny, :nx].permute(1, 2, 0)
            py, px = min(K.ENC0_OUT // 2, ho // 2 - y0 // 2), min(K.ENC0_STEP // 2, wo // 2 - x0 // 2)
            if py > 0 and px > 0:
                assert torch.isnan(pooled[bi, y0 // 2:y0 // 2 + py, x0 // 2:x0 // 2 + px]).all()
                pooled[bi, y0 // 2:y0 // 2 + py, x0 // 2:x0 // 2 + px] = \
                    pool[:, :py, :px].permute(1, 2, 0)
    return skip, pooled


@pytest.mark.parametrize("b,h,w,sms", [
    (2, 41, 23, SMS),  # two bands (the last 5 rows), ragged last column step, odd pool
    (1, 75, 20, 5),    # three bands, blocks of one or two steps across band seams
    (1, 7, 9, 2),      # one step: a single pooled row
    (1, 45, 60, 2),    # 14 steps on two blocks: 12 carries, one block starting mid-band
])
@pytest.mark.parametrize("bf16", [False, True])
def test_enc0_walk_emulation_equals_plain(b, h, w, sms, bf16):
    """The emulated walk equals enc0_fused_plain: in f32 to summation
    order; with the stem and conv1 rounded to bf16 where the kernel rounds
    them, within one rounding of the same chain computed whole, and its
    pool equal bit for bit to the 2x2 max of the stored rounded skip0. No
    stored value reads the NaN of an h pixel no stem wrote, nor a value
    past its image's edge."""
    rs = np.random.RandomState(h * w + sms)
    x = torch.from_numpy(rs.uniform(0, 1, (b, h, w, 1)).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    w0, b0 = _bf16_values(rs, 64, 1, 3, 3, scale=0.5), _bf16_values(rs, 64, scale=0.1)
    w1, b1 = _bf16_values(rs, 64, 64, 3, 3, scale=0.06), _bf16_values(rs, 64, scale=0.1)
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    skip, pooled = _enc0_emulation(x, w0, b0, w1, b1, sms, rnd)
    assert bool(torch.isfinite(skip).all()) and bool(torch.isfinite(pooled).all())
    if not bf16:
        r_skip, r_pool = K.enc0_fused_plain(x, w0, b0, w1, b1)
        torch.testing.assert_close(skip, r_skip, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(pooled, r_pool, rtol=1e-5, atol=1e-5)
        return
    hh = rnd(K.conv3x3_bias_relu_plain(x, w0, b0))
    ref = rnd(K.conv3x3_bias_relu_plain(hh, w1, b1))
    # the same roundings of sums taken in another order: one bf16 step apart
    assert bool(((skip - ref).abs() <= 2.0**-7 * ref.abs() + 1e-6).all())
    nchw = skip.permute(0, 3, 1, 2)
    assert torch.equal(pooled, F.max_pool2d(nchw, 2).permute(0, 2, 3, 1))
