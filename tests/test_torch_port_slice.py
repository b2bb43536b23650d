"""The port's serving slice against the JAX package on the CPU: the eval
U-Net, the folded kernel forward, and the tiled Predictor down to uint8
masks. Tiny nets (base_features=4, fp32); variables are seeded numpy
arrays in the Flax layout, handed to both packages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.core.config import InferConfig as JaxInferConfig
from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
from unetseg_tpu.infer.engine import Predictor as JaxPredictor
from unetseg_tpu.infer.folding import fold_batchnorm as jax_fold_batchnorm
from unetseg_tpu.infer.lanes_net import folded_forward_tier1
from unetseg_tpu.infer.tiling import TTA_TRANSFORMS as JAX_TTA
from unetseg_tpu.models.unet import UNet as JaxUNet
from unetseg_tpu_torch.core.config import InferConfig, ModelConfig
from unetseg_tpu_torch.infer.engine import Predictor
from unetseg_tpu_torch.infer.folding import fold_batchnorm
from unetseg_tpu_torch.infer.kernel_net import folded_forward_kernels, supports
from unetseg_tpu_torch.infer.tiling import extract_tiles, mirror_pad, plan_tiles, stitch
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.models.unet import UNet
from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict

TINY = dict(base_features=4, compute_dtype="float32")
SEED = 2  # a tiny random net whose probabilities spread around 0.5
TILE = 252  # output 68: a 60x60 frame is one tile, a 100x100 frame a 2x2 grid


@pytest.fixture(scope="module")
def variables():
    return fast_random_variables(ModelConfig(**TINY), SEED)


def _x(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("bilinear", [False, True])
def test_eval_unet_matches_flax(variables, bilinear):
    x = _x(0, 2, 188, 188, 1)
    if bilinear:
        variables = fast_random_variables(ModelConfig(bilinear=True, **TINY), SEED)
    ref = JaxUNet(cfg=JaxModelConfig(bilinear=bilinear, **TINY)).apply(
        variables, jnp.asarray(x), train=False
    )
    net = UNet(ModelConfig(bilinear=bilinear, **TINY))
    net.load_state_dict(flax_to_state_dict(variables))
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 4, 4, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("num_classes", [2, 3])
def test_kernel_forward_matches_tier1_and_folded_unet(variables, num_classes):
    """folded_forward_kernels (plain kernel versions on the CPU) against the
    TPU forward in interpret mode and against FoldedUNet; the port's plain
    FoldedUNet against the JAX FoldedUNet."""
    cfg = ModelConfig(num_classes=num_classes, **TINY)
    jcfg = JaxModelConfig(num_classes=num_classes, **TINY)
    if num_classes != 2:
        variables = fast_random_variables(cfg, SEED)
    assert supports(cfg, torch.device("cpu"))
    x = _x(1, 2, 188, 188, 1)
    jfm, jfv = jax_fold_batchnorm(jcfg, variables)
    ref_folded = np.asarray(jfm.apply(jfv, jnp.asarray(x)))
    ref_tier1 = np.asarray(
        folded_forward_tier1(jfv["params"], jnp.asarray(x), jcfg, interpret=True)
    )
    folded = fold_batchnorm(cfg, flax_to_state_dict(variables))
    with torch.inference_mode():
        got = folded_forward_kernels(folded, torch.from_numpy(x)).numpy()
        plain = folded(torch.from_numpy(x)).numpy()
    assert got.shape == ref_tier1.shape == (2, 4, 4, num_classes)
    np.testing.assert_allclose(got, ref_tier1, atol=5e-4)
    np.testing.assert_allclose(got, ref_folded, atol=5e-4)
    np.testing.assert_allclose(plain, ref_folded, atol=5e-4)


def test_kernel_forward_support_by_device():
    """On a CUDA device the kernel forward needs the kernels' widths and
    dtype; on the CPU the plain kernel versions take any width."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert supports(ModelConfig(), cuda)
    assert supports(ModelConfig(num_classes=3), cuda)
    assert not supports(ModelConfig(base_features=32), cuda)
    assert not supports(ModelConfig(compute_dtype="float32"), cuda)
    assert supports(ModelConfig(base_features=32, compute_dtype="float32"), cpu)
    for cfg in (ModelConfig(bilinear=True), ModelConfig(levels=4)):
        assert not supports(cfg, cpu) and not supports(cfg, cuda)


def _port_tiled_probs(pred, imgs, grid):
    tiles = extract_tiles(mirror_pad(torch.from_numpy(imgs), grid), grid)
    f, n = tiles.shape[:2]
    with torch.inference_mode():
        p = pred._probs(tiles.reshape(f * n, grid.tile_in, grid.tile_in))
    o = grid.tile_out
    return stitch(p.reshape(f, n, o, o), grid).numpy()


@pytest.mark.parametrize(
    "shape,tta,merge",
    [
        ((2, 60, 60), "none", "mean"),
        ((1, 100, 100), "none", "mean"),
        ((2, 60, 60), "flips", "gmean"),
        ((2, 60, 60), "flips", "vote"),
    ],
)
def test_masks_tiled_matches_jax_predictor(variables, shape, tta, merge):
    """Tiled probabilities agree to 1e-4 for every TTA transform, and the
    uint8 masks are identical except where a JAX probability (or the
    merged statistic) lies within 1e-3 of the threshold."""
    kw = dict(tile_input=TILE, tile_batch=2, tta=tta, tta_merge=merge)
    jpred = JaxPredictor(
        model=JaxUNet(cfg=JaxModelConfig(**TINY)), params=variables["params"],
        batch_stats=variables["batch_stats"], cfg=JaxInferConfig(**kw),
    )
    pred = Predictor(ModelConfig(**TINY), variables, InferConfig(**kw), "cpu")
    imgs = _x(3, *shape)
    thr = pred.cfg.threshold
    grid = plan_tiles(shape[1], shape[2], TILE)

    near = np.zeros(shape, bool)
    jax_ps = []
    for fwd, inv in JAX_TTA[tta]:
        t_imgs = np.ascontiguousarray(fwd(imgs))
        jp = np.stack([jpred.probs_tiled(im) for im in t_imgs])
        pp = _port_tiled_probs(pred, t_imgs, grid)
        np.testing.assert_allclose(pp, jp, atol=1e-4)
        jp = np.asarray(inv(jp))
        jax_ps.append(jp)
        near |= np.abs(jp - thr) < 1e-3
    if merge == "mean":
        near |= np.abs(np.mean(jax_ps, axis=0) - thr) < 1e-3
    if merge == "gmean":
        near |= np.abs(np.exp(np.mean(np.log(np.array(jax_ps) + 1e-7), axis=0)) - thr) < 1e-3

    got = pred.masks_tiled(imgs)
    want = jpred.masks_tiled(imgs)
    assert got.shape == want.shape == shape and got.dtype == np.uint8
    assert near.mean() < 0.02 and 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got[~near], want[~near])


def test_predictor_rejects_unknown_merge_and_ensembles(variables):
    cfg = ModelConfig(**TINY)
    with pytest.raises(ValueError, match="tta_merge"):
        Predictor(cfg, variables, InferConfig(tta_merge="median"), "cpu")
    with pytest.raises(ValueError, match="ensemble_merge"):
        Predictor(cfg, [variables, variables], InferConfig(ensemble_merge="max"), "cpu")


def test_predict_image_and_probs_shapes(variables):
    pred = Predictor(
        ModelConfig(**TINY), variables, dataclasses.replace(InferConfig(), normalize=True), "cpu"
    )
    img = _x(4, 188, 188)
    m = pred.predict_image(img)
    p = pred.probs(img[None])
    assert m.shape == (4, 4) and m.dtype == np.uint8
    np.testing.assert_array_equal(m, (p[0] > pred.cfg.threshold).numpy().astype(np.uint8))
