"""The port's augmentation and targets against the JAX package on the CPU:
elastic deformation, photometric gamma / illumination, noise,
standardization and the 3-class targets. The JAX functions draw from a key;
the port's apply functions get the same draws, made here with jax.random
exactly as the JAX functions make them, handed over as numpy. Masks must
come out exact; images within 2e-5 (f32, the same operations in another
summation order; elastic: the blur's band-matrix products and the
bilinear taps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unetseg_tpu.ops import elastic as jel
from unetseg_tpu.ops import intensity as jint
from unetseg_tpu.train.steps import three_class_targets as jax_three_class
from unetseg_tpu_torch.ops import elastic as el
from unetseg_tpu_torch.ops import intensity as it
from unetseg_tpu_torch.train.steps import three_class_targets


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_elastic_uniforms(key, b, h, w):
    """The (B, 2, H, W) U[-1, 1] fields elastic_deform_batch draws: one
    subkey per item, split into (dx, dy) keys (ops/elastic.py:112-114)."""
    out = []
    for k in jax.random.split(key, b):
        kx, ky = jax.random.split(k)
        out.append([jax.random.uniform(kx, (h, w), jnp.float32, -1.0, 1.0),
                    jax.random.uniform(ky, (h, w), jnp.float32, -1.0, 1.0)])
    return np.asarray(out)


def _frames(seed, b, h, w, labels=7):
    rs = np.random.RandomState(seed)
    return rs.rand(b, h, w).astype(np.float32), rs.randint(0, labels, (b, h, w)).astype(np.int32)


@pytest.mark.parametrize("alpha,sigma,h,w", [(30.0, 4.0, 40, 52), (2000.0, 20.0, 64, 64)])
def test_elastic_deform_matches_jax(alpha, sigma, h, w):
    """A small field, and the recipe's alpha 2000 / sigma 20 (large
    displacements: clamped coordinates and reflections)."""
    imgs, masks = _frames(int(alpha), 2, h, w)
    key = jax.random.key(4)
    want_img, want_mask = jel.elastic_deform_batch(key, jnp.asarray(imgs), jnp.asarray(masks),
                                                   alpha=alpha, sigma=sigma)
    u = jax_elastic_uniforms(key, 2, h, w)
    img, mask = el.elastic_deform_batch(_t(imgs), _t(masks), _t(u), alpha=alpha, sigma=sigma)
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), atol=2e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_blur_and_halo_helpers_match_jax():
    for size, sigma in ((40, 4.0), (97, 20.0)):
        np.testing.assert_array_equal(el.blur_band_matrix(size, sigma).numpy(),
                                      np.asarray(jel.blur_band_matrix(size, sigma)))
        np.testing.assert_array_equal(el.gaussian_kernel1d(sigma).numpy(),
                                      np.asarray(jel.gaussian_kernel1d(sigma)))
    x = np.random.RandomState(0).rand(3, 40, 52).astype(np.float32)
    np.testing.assert_allclose(el.gaussian_blur_2d(_t(x), 4.0).numpy(),
                               np.stack([np.asarray(jel.gaussian_blur_2d(jnp.asarray(a), 4.0))
                                         for a in x]), atol=1e-6)
    idx = np.arange(-300, 300)
    np.testing.assert_array_equal(el.reflect_index(_t(idx), 37).numpy(),
                                  np.asarray(jel.reflect_index(jnp.asarray(idx), 37)))
    for alpha, sigma in ((2000.0, 20.0), (30.0, 4.0), (5.0, 0.5)):
        assert el.displacement_pad(alpha, sigma) == jel.displacement_pad(alpha, sigma)


def test_illumination_resize_matches_jax_image_resize():
    """F.interpolate(bilinear, align_corners=False) of the 4x4 grid equals
    jax.image.resize(..., "bilinear") when upsampling: both sample at
    half-pixel centres, and torch's edge clamp gives what JAX's edge
    renormalisation gives."""
    coarse = np.random.RandomState(1).uniform(-1, 1, (3, 4, 4)).astype(np.float32)
    for h, w in ((512, 512), (37, 50)):
        want = jax.image.resize(jnp.asarray(coarse), (3, h, w), method="bilinear")
        got = F.interpolate(_t(coarse)[:, None], size=(h, w), mode="bilinear",
                            align_corners=False)[:, 0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_photometric_noise_standardize_match_jax():
    gamma_log, illum, max_std = 0.35, 0.15, 0.05
    imgs, _ = _frames(9, 3, 40, 52)
    key = jax.random.key(8)
    want = jint.photometric_augment_batch(key, jnp.asarray(imgs), gamma_log=gamma_log, illum=illum)
    kg, ki = jax.random.split(key)
    log_g = jax.random.uniform(kg, (3, 1, 1), minval=-gamma_log, maxval=gamma_log)[:, 0, 0]
    coarse = jax.random.uniform(ki, (3, 4, 4), minval=-1.0, maxval=1.0)
    got = it.photometric_augment_batch(_t(imgs), _t(log_g), _t(coarse), illum=illum)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)

    want_n = jint.gaussian_noise_batch(key, want, max_std)
    ks, kn = jax.random.split(key)
    sigma = jax.random.uniform(ks, (3, 1, 1), maxval=max_std)[:, 0, 0]
    noise = jax.random.normal(kn, want.shape)
    got_n = it.gaussian_noise_batch(got, _t(sigma), _t(noise))
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), atol=2e-6)

    np.testing.assert_allclose(it.standardize_batch(got_n).numpy(),
                               np.asarray(jint.standardize_batch(want_n)), atol=2e-5)
    flat = np.full((1, 8, 8), 0.3, np.float32)  # zero std: the 1e-6 floor
    np.testing.assert_allclose(it.standardize_batch(_t(flat)).numpy(),
                               np.asarray(jint.standardize_batch(jnp.asarray(flat))), atol=1e-6)


def test_three_class_targets_match_jax():
    rs = np.random.RandomState(2)
    masks = np.zeros((2, 30, 33), np.int32)
    for lab in range(1, 9):  # touching and overlapping blobs at the edges too
        y, x = rs.randint(-3, 30), rs.randint(-3, 33)
        masks[:, max(y, 0):y + 9, max(x, 0):x + 11] = lab
    masks[1] = np.roll(masks[1], 5, axis=1)
    got = three_class_targets(_t(masks))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_three_class(jnp.asarray(masks))))


def test_draws_have_the_jax_distributions():
    """The port's own draws: the ranges and shapes the JAX draws have."""
    g = torch.Generator().manual_seed(0)
    u = el.draw_elastic(g, 2, 16, 24)
    assert u.shape == (2, 2, 16, 24) and -1 <= u.min() and u.max() < 1
    lg, coarse = it.draw_photometric(g, 3, 0.35, 0.15)
    assert lg.shape == (3,) and lg.abs().max() <= 0.35 and coarse.shape == (3, 4, 4)
    assert it.draw_photometric(g, 3, 0.0, 0.0) == (None, None)
    sigma, noise = it.draw_noise(g, (3, 16, 24), 0.05)
    assert sigma.shape == (3,) and 0 <= sigma.min() and sigma.max() < 0.05
    assert noise.shape == (3, 16, 24) and abs(float(noise.std()) - 1) < 0.1
