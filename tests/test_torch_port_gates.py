"""The gated net (ModelConfig.skip_gates, the Attention U-Net of
arXiv:1804.03999) on the CPU, against the benchmark's plain reference
(benchmark/reference/attn_unet.py; the JAX package has no gates): the plain
UNet, the folded net and the kernel serving forward's CPU route in f32 and
in bf16, the kernel train forward's loss and every leaf's gradient, the
gate wrappers' plain versions at odd crop offsets, the bridge's round trip
of the gate leaves, `--skip-gates` reaching ModelConfig on every command
that takes `--bilinear`, a gated `train()` run on the kernel train
forward, and an ungated net left as it was. Small nets on seeded random
weights (synth.variables, the benchmark's draws)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import synth  # noqa: E402
from reference import attn_unet as ref  # noqa: E402
from reference.precision import fp8  # noqa: E402

from unetseg_tpu_torch.cli.main import _model_cfg, build_parser  # noqa: E402
from unetseg_tpu_torch.core.config import Config, ModelConfig  # noqa: E402
from unetseg_tpu_torch.infer.engine import Predictor  # noqa: E402
from unetseg_tpu_torch.infer.folding import fold_batchnorm  # noqa: E402
from unetseg_tpu_torch.infer.kernel_net import folded_forward_kernels, supports  # noqa: E402
from unetseg_tpu_torch.models.fast_init import fast_random_variables  # noqa: E402
from unetseg_tpu_torch.models.train_forward import train_forward  # noqa: E402
from unetseg_tpu_torch.models.unet import UNet, split_state_dict  # noqa: E402
from unetseg_tpu_torch.ops.kernels import attn_gate as G  # noqa: E402
from unetseg_tpu_torch.ops.kernels.launches import launch_counts, reset_launch_counts  # noqa: E402
from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict, state_dict_to_flax  # noqa: E402

SIZE = 188  # the smallest valid input: 4x4 logits
# f32 against f32: the same products, summed in other orders by other conv
# algorithms over ~20 layers
F32_ATOL = 2e-5
# bf16 against the f32 reference: rms logit error over the reference's std.
# bf16 rounds every stored activation to 2^-9 relative, which compounds to
# 1-3% over the net (0.011-0.028 at these seeds); fp8 (e4m3, 2^-4) reads
# 0.17-0.29 on the same comparison, so this bound fails it
BF16_REL = 0.05
BASE = 8
# the sum of fast_random_variables(base 4, seed 0)'s leaves as the tree drew
# them before the gates (numpy RandomState: the same on every platform)
FAST_SUM = 771.6455551772779
# a leaf's gradient difference norm over its norm, f32 both ways: the
# moments' order (as the loss's) through each BatchNorm's backward
GRAD_REL = 1e-3


def _model(base=BASE, classes=2):
    return {"in_channels": 1, "num_classes": classes, "base_features": base, "levels": 5}


def _cfg(dtype="float32", base=BASE, **kw):
    return ModelConfig(base_features=base, compute_dtype=dtype, skip_gates=True, **kw)


def _variables(seed, base=BASE):
    return synth.variables(ref, _model(base), seed, "cpu")


def _x(seed, b=2, size=SIZE):
    return torch.rand((b, size, size), generator=torch.Generator().manual_seed(seed))


def _reference(v, x, base=BASE, quant=None):
    params, stats = ref.to_tensors(v, "cpu")
    with torch.no_grad():
        return ref.forward(params, stats, x[:, None], _model(base), quant=quant)[0]


def _nchw(y):
    return y.permute(0, 3, 1, 2)


def _rel(got, want):
    return ((got.float() - want).pow(2).mean().sqrt() / want.std()).item()


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_unet_matches_the_reference(seed):
    v, x = _variables(seed), _x(seed)
    want = _reference(v, x)
    net = UNet(_cfg())
    net.load_state_dict(flax_to_state_dict(v))
    with torch.no_grad():
        got = _nchw(net(x[..., None]))
    assert got.shape == want.shape == (2, 2, 4, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_folded_and_kernel_route_match_the_reference(seed):
    """The folded net and the kernel forward's CPU route (the gate
    wrappers' plain versions) in f32 and bf16; the CPU route launches
    nothing and gives the folded net's bits."""
    v, x = _variables(seed), _x(seed)
    want = _reference(v, x)
    for dtype in ("float32", "bfloat16"):
        folded = fold_batchnorm(_cfg(dtype), flax_to_state_dict(v))
        reset_launch_counts()
        with torch.no_grad():
            plain, kern = folded(x[..., None]), folded_forward_kernels(folded, x[..., None])
        assert not any(launch_counts().values())
        assert torch.equal(plain, kern)
        if dtype == "float32":
            torch.testing.assert_close(_nchw(kern), want, rtol=0, atol=F32_ATOL)
        else:
            assert _rel(_nchw(kern), want) <= BF16_REL


def test_bf16_bound_fails_fp8():
    """The reference in fp8 (the benchmark's control) breaks BF16_REL where
    the bf16 nets keep it."""
    for seed in (1, 2):
        v, x = _variables(seed), _x(seed)
        assert _rel(_reference(v, x, quant=fp8), _reference(v, x)) > 2 * BF16_REL


@pytest.mark.parametrize("variant", [dict(dec_fuse="tail"), dict(tier2=True),
                                     dict(fused_enc0=True)], ids=["tail", "tier2", "enc0"])
def test_variants_read_the_gated_crop(variant):
    """The options whose entries read a skip at an offset read the gated
    crop at (0, 0): the folded net's bits on the CPU route."""
    v, x = _variables(3), _x(3)
    folded = fold_batchnorm(_cfg(), flax_to_state_dict(v))
    with torch.no_grad():
        assert torch.equal(folded_forward_kernels(folded, x[..., None], **variant),
                           folded(x[..., None]))


def test_predictor_serves_the_gated_net_through_the_kernel_forward():
    v = _variables(4)
    from unetseg_tpu_torch.core.config import InferConfig

    p = Predictor(_cfg(), v, InferConfig(tile_input=SIZE, tile_batch=4), "cpu")
    assert p.uses_kernels and supports(_cfg(), torch.device("cpu"))
    assert supports(_cfg("bfloat16", base=64), torch.device("cuda"))
    frames = np.random.RandomState(0).rand(2, 6, 6).astype(np.float32)
    assert p.masks_tiled(frames).shape == (2, 6, 6)


@pytest.mark.parametrize("off", [(88, 88), (41, 40), (3, 0)])
def test_gate_wrappers_plain_at_crop_offsets(off):
    """attn_gate and attn_gate_apply on CPU tensors (their plain versions)
    against the reference's gate at the crop: alpha in f32, x_hat =
    upsample2x(alpha) * crop."""
    g = torch.Generator().manual_seed(7)
    f, h = 8, 5
    skip = torch.rand(2, 2 * h + off[0] + 3, 2 * h + off[1] + 1, f, generator=g)
    gg = torch.rand(2, h, h, 2 * f, generator=g)
    wx, wg = torch.randn(f // 2, f, 2, 2, generator=g), torch.randn(f // 2, 2 * f, 1, 1, generator=g)
    bg, psi, bpsi = torch.randn(f // 2, generator=g), torch.randn(1, f // 2, 1, 1, generator=g), \
        torch.randn(1, generator=g)
    reset_launch_counts()
    alpha = G.attn_gate(skip, gg, wx, wg, bg, psi, bpsi, *off)
    x_hat = G.attn_gate_apply(skip, alpha, *off)
    assert launch_counts()["attn_gate"] == launch_counts()["attn_gate_apply"] == 0
    crop = skip[:, off[0]:off[0] + 2 * h, off[1]:off[1] + 2 * h].permute(0, 3, 1, 2)
    params = {"gate0/wx/kernel": wx, "gate0/wg/kernel": wg, "gate0/wg/bias": bg,
              "gate0/psi/kernel": psi, "gate0/psi/bias": bpsi}
    want = ref.gate(params, 0, crop, gg.permute(0, 3, 1, 2), lambda t: t)
    assert alpha.shape == (2, h, h) and alpha.dtype == torch.float32
    torch.testing.assert_close(alpha, want[:, 0], rtol=0, atol=1e-6)
    up = torch.nn.functional.interpolate(want, scale_factor=2, mode="bilinear",
                                         align_corners=False)
    torch.testing.assert_close(x_hat, (up * crop).permute(0, 2, 3, 1), rtol=0, atol=1e-6)
    assert x_hat.is_contiguous()


def test_gate_kernel_tiles_cover_g_once():
    """csrc/attn_gate.cu's walk: tile t of image b covers rows 8 (t' // n)
    .. + 7 and columns 16 (t' % n) .. + 15 of g, t' = t % tiles an image;
    every pixel of g in exactly one tile at the 700^2 and 512^2 levels. The
    mirror's constants are the source's."""
    from unetseg_tpu_torch.ops.kernels.build import CSRC

    th, tw = G.GATE_TILE
    src = (CSRC / "attn_gate.cu").read_text()
    assert f"constexpr int TH = {th}, TW = {tw};" in src
    assert "(rem / ntw) * TH" in src and "(rem % ntw) * TW" in src
    for h in (36, 68, 132, 260, 24, 44, 84, 164, 5):
        n_w = -(-h // tw)
        per = G.tile_count(1, h, h)
        hits = np.zeros((h, h), np.int64)
        for t in range(per):
            r0, c0 = (t // n_w) * th, (t % n_w) * tw
            hits[r0:r0 + th, c0:c0 + tw] += 1
        assert (hits == 1).all() and G.tile_count(16, h, h) == 16 * per


def _loss(logits, seed):
    """A fixed linear functional of the logits: its gradient is the
    weights, so each leaf's gradient is the net's own backward."""
    w = torch.randn(logits.shape, generator=torch.Generator().manual_seed(seed))
    return (logits * w).mean()


@pytest.mark.parametrize("tier2", [False, True], ids=["tier1", "tier2"])
def test_train_forward_loss_and_grads_match_the_reference(tier2):
    """The kernel train forward (CPU route) in f32 against the reference in
    train mode: the loss, the new running statistics and every leaf's
    gradient, the gate leaves included; the biases before a BatchNorm (the
    convs' and the up-convs'), whose true gradient is 0 (BN removes any
    shift; the kernel forward detaches the middle's), read under 1e-3 of
    the median leaf's on both sides."""
    seed = 5
    v = _variables(seed)
    x = _x(seed, b=2)
    cfg = _cfg()
    params, stats = split_state_dict(flax_to_state_dict(v))
    params = {k: t.clone().requires_grad_() for k, t in params.items()}
    logits, new_stats = train_forward(params, stats, x[..., None], cfg, tier2=tier2)
    loss = _loss(_nchw(logits), seed)
    loss.backward()
    rp, rs = ref.to_tensors(v, "cpu")
    rp = {k: t.clone().requires_grad_() for k, t in rp.items()}
    rlogits, rstats = ref.forward(rp, rs, x[:, None], _model(), train=True)
    rloss = _loss(rlogits, seed)
    rloss.backward()
    # f32 both ways; the port's BatchNorm takes one-pass moments (E[x^2] -
    # E[x]^2), the reference two-pass ones: ~1e-5 relative by the logits
    torch.testing.assert_close(loss, rloss, rtol=1e-4, atol=1e-7)
    for k, t in new_stats.items():
        torch.testing.assert_close(t, rstats[ref.ref_key(k)], rtol=1e-4, atol=1e-6)
    scale = np.median([rp[k].grad.norm().item() for k in rp])
    gates = 0
    for k, t in params.items():
        want = rp[ref.ref_key(k)].grad
        if want.norm().item() < 1e-3 * scale:  # a bias before BN: BN removes any shift
            assert k.endswith(("conv0.bias", "conv1.bias", "_tconv.bias")), k
            assert t.grad is None or t.grad.norm().item() < 1e-3 * scale, k
            continue
        err = ((t.grad - want).norm() / want.norm()).item()
        assert err < GRAD_REL, (k, err)
        gates += k.startswith("gate")
    assert gates == 5 * 4  # wx, wg and its bias, psi and its bias at 4 levels


def test_bridge_round_trips_the_gate_leaves():
    """Flax layout -> state dict -> Flax layout, bit for bit, for the
    reference's draws and for models/fast_init's; the UNet takes the
    state dict with the gate modules' names."""
    for v in (_variables(6), fast_random_variables(_cfg(), 6)):
        sd = flax_to_state_dict(v)
        assert {k for k in sd if k.startswith("gate3.")} == {
            "gate3.wx.weight", "gate3.wg.weight", "gate3.wg.bias", "gate3.psi.weight",
            "gate3.psi.bias"}
        assert tuple(sd["gate0.wx.weight"].shape) == (4 * BASE, 8 * BASE, 2, 2)
        UNet(_cfg()).load_state_dict(sd)
        back = state_dict_to_flax(sd)
        flat_v, flat_b = dict(_leaves(v)), dict(_leaves(back))
        assert flat_v.keys() == flat_b.keys()
        for k in flat_v:
            np.testing.assert_array_equal(flat_b[k], flat_v[k], err_msg=k)


def _leaves(tree, prefix=""):
    for k, t in tree.items():
        if isinstance(t, dict):
            yield from _leaves(t, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(t)


def test_param_count_is_the_papers_net_with_gates():
    from unetseg_tpu_torch.models.unet import param_count

    assert param_count(UNet(ModelConfig(skip_gates=True))) == 32_087_878
    assert param_count(UNet(ModelConfig())) == 31_042_434


@pytest.mark.parametrize("command", ["train", "infer", "predict", "evaluate", "export"])
def test_skip_gates_flag_reaches_model_config(command):
    base = {"train": [], "infer": ["--input", "x"], "predict": [], "evaluate": [],
            "export": []}[command]
    parser = build_parser()
    for flag, want in (([], False), (["--skip-gates"], True)):
        try:
            args = parser.parse_args([command, *base, *flag])
        except SystemExit:  # a command with a required argument of its own
            pytest.fail(f"{command} {flag} did not parse")
        assert _model_cfg(Config(), args).skip_gates is want


def test_cli_train_skip_gates_runs_the_gated_net(tmp_path, monkeypatch):
    """`train --skip-gates` hands train() a gated ModelConfig, and train()
    runs it on the kernel train forward (lanes "on" on the CPU) for two
    steps; the checkpoint's config records the field."""
    from unetseg_tpu_torch.cli.main import main
    from unetseg_tpu_torch.data import dataset
    from unetseg_tpu_torch.train import checkpoint as ckpt
    from unetseg_tpu_torch.train import loop

    seen = []
    real = loop.train

    def train(cfg, **kw):
        seen.append(cfg)
        rs = np.random.RandomState(0)
        imgs = rs.rand(4, SIZE, SIZE).astype(np.float32)
        masks = (imgs > 0.5).astype(np.int32)
        data = dataset.HeLaArrays(imgs, masks, np.ones_like(imgs), [])
        cfg = cfg.replace(train=cfg.train.__class__(**{**cfg.train.__dict__, "lanes": "on"}))
        return real(cfg, data=data, max_steps=2, device=kw["device"])

    monkeypatch.setattr(loop, "train", train)
    conf = tmp_path / "tiny.json"
    conf.write_text(json.dumps({"model": {"base_features": 4},
                                "train": {"batch_size": 2, "num_epochs": 1},
                                "data": {"augment": False}}))
    ck = tmp_path / "ck"
    assert main(["train", "--cpu", "--skip-gates", "--config", str(conf), "--dtype", "float32",
                 "--data-root", str(tmp_path), "--checkpoint-dir", str(ck)]) == 0
    assert seen and seen[0].model.skip_gates
    written = [json.loads(p.read_text()) for p in ck.rglob("*.json")]
    assert written and all(w["config"]["model"]["skip_gates"] for w in written
                           if "config" in w)


def test_ungated_net_is_unchanged():
    """skip_gates=False: no gate modules or leaves, the same draws as
    before the field (models/fast_init's stream), a written config without
    the field, and the forward of reference/unet.py (the ungated
    reference)."""
    from reference import unet as ref_unet

    cfg = ModelConfig(base_features=4, compute_dtype="float32")
    net = UNet(cfg)
    assert not [k for k in net.state_dict() if k.startswith("gate")]
    v = fast_random_variables(cfg, 0)
    assert "gate0" not in v["params"]
    digest = np.concatenate([a.ravel() for _, a in _leaves(v)]).astype(np.float64).sum()
    assert digest == pytest.approx(FAST_SUM, rel=0, abs=1e-9)
    assert "skip_gates" not in Config(model=cfg).to_dict()["model"]
    vu = synth.variables(ref_unet, _model(4), 9, "cpu")
    net.load_state_dict(flax_to_state_dict(vu))
    x = _x(9)
    params, stats = ref_unet.to_tensors(vu, "cpu")
    with torch.no_grad():
        want = ref_unet.forward(params, stats, x[:, None], _model(4))[0]
        got = _nchw(net(x[..., None]))
    torch.testing.assert_close(got, want, rtol=0, atol=F32_ATOL)
