"""The port's min-plus product, exact EDT and weight maps against the JAX
package on the CPU (the kernel wrapper runs its plain version there; the
JAX side runs its Pallas min-plus in interpret mode or its XLA product).

Tolerances: the min-plus products and the EDT are exact (every candidate
is one f32 add of integers below 2^24 or of 1e12, min is exact), so they
are held bit for bit; the EDT against scipy to 1e-4 (sqrt of exact
squares against scipy's float64); the device weight maps to 1e-5 of the
JAX device maps (the same f32 formula; exp and sqrt of two libraries),
the host maps bit for bit (the same numpy code).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import distance_transform_edt as sp_edt

from unetseg_tpu.ops.pallas.minplus import edt_sq_pallas
from unetseg_tpu.ops.pallas.minplus import minplus as jax_minplus
from unetseg_tpu_torch.ops import edt, weight_maps
from unetseg_tpu_torch.ops.kernels.minplus import minplus, minplus_plain

# unetseg_tpu.ops re-exports functions named like its modules
jax_edt = importlib.import_module("unetseg_tpu.ops.edt")
jax_wm = importlib.import_module("unetseg_tpu.ops.weight_maps")


def _int_matrix(rs, shape, big_frac=0.2):
    m = rs.randint(0, 5000, shape).astype(np.float32)
    m[rs.rand(*shape) < big_frac] = 1e12
    return m


def test_minplus_plain_equals_jax_pallas_interpret():
    rs = np.random.RandomState(0)
    a, b = _int_matrix(rs, (130, 200)), _int_matrix(rs, (200, 70))
    want = np.asarray(jax_minplus(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = minplus_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version on the CPU and launches nothing
    minplus.launches = 0
    np.testing.assert_array_equal(minplus(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)
    assert minplus.launches == 0


@pytest.mark.parametrize("shared", ["a", "b"])
def test_minplus_batched_with_a_shared_operand_equals_the_loop(shared):
    rs = np.random.RandomState(1)
    a = torch.from_numpy(_int_matrix(rs, (37, 45) if shared == "a" else (3, 37, 45)))
    b = torch.from_numpy(_int_matrix(rs, (3, 45, 29) if shared == "a" else (45, 29)))
    got = minplus_plain(a, b)
    assert got.shape == (3, 37, 29)
    for z in range(3):
        az = a if shared == "a" else a[z]
        bz = b[z] if shared == "a" else b
        assert torch.equal(got[z], minplus_plain(az, bz))


def test_minplus_rejects_shapes_that_do_not_multiply():
    with pytest.raises(ValueError, match="inner"):
        minplus_plain(torch.zeros(3, 4), torch.zeros(5, 6))
    with pytest.raises(ValueError, match="batch sizes"):
        minplus_plain(torch.zeros(2, 3, 4), torch.zeros(3, 4, 6))


def _features(rs, h, w, p):
    return rs.rand(h, w) < p


@pytest.mark.parametrize("case", ["sparse", "empty", "single"])
def test_edt_sq_equals_jax(case):
    rs = np.random.RandomState(2)
    f = np.zeros((33, 47), bool)
    if case == "sparse":
        f = _features(rs, 33, 47, 0.05)
    elif case == "single":
        f[5, 40] = True
    want = np.asarray(jax_edt.edt_sq(jnp.asarray(f)))
    np.testing.assert_array_equal(np.asarray(edt_sq_pallas(jnp.asarray(f), interpret=True)), want)
    got = edt.edt_sq(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got, want)
    # batched planes equal the planes one at a time
    stack = np.stack([f, _features(rs, 33, 47, 0.1), np.zeros_like(f)])
    got3 = edt.edt_sq(torch.from_numpy(stack)).numpy()
    for k in range(3):
        np.testing.assert_array_equal(got3[k], np.asarray(jax_edt.edt_sq(jnp.asarray(stack[k]))))


def test_distance_transform_edt_matches_scipy():
    rs = np.random.RandomState(3)
    x = (rs.rand(48, 57) > 0.1).astype(np.uint8)
    got = edt.distance_transform_edt(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, sp_edt(x), atol=1e-4)
    np.testing.assert_array_equal(
        got, np.asarray(jax_edt.distance_transform_edt(jnp.asarray(x))))
    np.testing.assert_allclose(edt.edt(torch.from_numpy(x == 0)).numpy()[x == 1],
                               sp_edt(x)[x == 1], atol=1e-4)


def _toy_mask():
    m = np.zeros((40, 40), np.uint16)
    m[5:15, 5:15] = 1
    m[5:15, 20:30] = 2
    m[25:35, 10:25] = 7  # non-consecutive label
    return m


def _crowded_mask(n=40, size=64, seed=4):
    """n small rectangles at random places; later ones overwrite earlier."""
    rs = np.random.RandomState(seed)
    m = np.zeros((size, size), np.int32)
    for lab in range(1, n + 1):
        y, x = rs.randint(0, size - 6, 2)
        h, w = rs.randint(2, 6, 2)
        m[y : y + h, x : x + w] = lab
    return m


@pytest.mark.parametrize("mode", ["reference", "paper"])
def test_host_weight_maps_equal_jax(mode):
    for m in (_toy_mask(), _crowded_mask(), np.zeros((16, 16), np.uint16)):
        np.testing.assert_array_equal(weight_maps.weight_map_np(m, mode=mode),
                                      jax_wm.weight_map_np(m, mode=mode))
    np.testing.assert_array_equal(weight_maps.class_balance_weights_np(_toy_mask()),
                                  jax_wm.class_balance_weights_np(_toy_mask()))


def test_pack_labels_equals_jax():
    for m in (_toy_mask(), _crowded_mask()):
        np.testing.assert_array_equal(weight_maps.pack_labels(m), jax_wm.pack_labels(m))
    assert weight_maps.pack_labels(_crowded_mask()).shape == (64,)
    assert weight_maps.INSTANCE_BUCKETS == jax_wm.INSTANCE_BUCKETS
    with pytest.raises(ValueError, match="max_instances"):
        weight_maps.pack_labels(_crowded_mask(), max_instances=32)
    many = np.arange(300, dtype=np.int32).reshape(15, 20)
    with pytest.raises(ValueError, match="max bucket"):
        weight_maps.pack_labels(many)


@pytest.mark.parametrize("which", ["toy", "crowded", "one", "none"])
def test_weight_map_device_equals_jax(which):
    m = {"toy": _toy_mask, "crowded": _crowded_mask}.get(which, lambda: None)()
    if which == "one":
        m = np.zeros((24, 30), np.int32)
        m[4:9, 10:20] = 3
    elif which == "none":
        m = np.zeros((24, 30), np.int32)
    labels = jax_wm.pack_labels(m)
    want = np.asarray(jax_wm.weight_map_device(jnp.asarray(m.astype(np.int32)),
                                               jnp.asarray(labels)))
    got = weight_maps.weight_map_device(torch.from_numpy(m.astype(np.int32)),
                                        torch.from_numpy(labels)).numpy()
    assert got.dtype == np.float32 and got.shape == m.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the dispatcher: the device path in paper mode, within 1e-3 of scipy
    host = weight_maps.weight_map_np(m, mode="paper")
    np.testing.assert_allclose(weight_maps.weight_map(m, mode="paper", device="cpu"), host,
                               atol=1e-3)
    # the reference formula has no device version: the host's, whatever the device
    np.testing.assert_array_equal(weight_maps.weight_map(m, device="cpu"),
                                  weight_maps.weight_map_np(m))


def _grid_mask(rows=20, cols=15, size=64, seed=8):
    """rows x cols 2x2 instances on a pitch of 3 x 4 pixels, their labels a
    random sample of 1..5000 (not consecutive)."""
    m = np.zeros((size, size), np.int32)
    labels = np.random.RandomState(seed).choice(np.arange(1, 5001), rows * cols, replace=False)
    for k, lab in enumerate(labels):
        y, x = 3 * (k // cols), 4 * (k % cols)
        m[y : y + 2, x : x + 2] = lab
    return m


def _count_edt_calls(monkeypatch):
    calls = []
    real = weight_maps.edt_sq
    monkeypatch.setattr(weight_maps, "edt_sq", lambda f: calls.append(f.shape[0]) or real(f))
    return calls


def test_weight_map_paper_takes_every_instance(monkeypatch):
    """300 instances, more than pack_labels' largest bucket (256): the
    dispatcher hands all of them to the device path, which runs them in
    two EDT batches (256 + 44) and lies within 1e-3 of scipy's map."""
    m = _grid_mask()
    assert len(np.unique(m)) - 1 == 300
    calls = _count_edt_calls(monkeypatch)
    got = weight_maps.weight_map(m, mode="paper", device="cpu")
    assert calls == [weight_maps.EDT_CHUNK, 300 - weight_maps.EDT_CHUNK]
    assert got.dtype == np.float32 and got.shape == m.shape
    np.testing.assert_allclose(got, weight_maps.weight_map_np(m, mode="paper"), atol=1e-3)


def test_weight_map_device_chunks_equal_one_batch(monkeypatch):
    """EDT_CHUNK = 8 over 30 instances (four batches, the last of 6) gives
    the single batch's map bit for bit: the running top-2 is a min over
    the same values."""
    m = torch.from_numpy(_grid_mask(rows=6, cols=5, size=20, seed=9))
    labels = torch.unique(m)[1:]
    calls = _count_edt_calls(monkeypatch)
    one = weight_maps.weight_map_device(m, labels)
    monkeypatch.setattr(weight_maps, "EDT_CHUNK", 8)
    chunked = weight_maps.weight_map_device(m, labels)
    assert calls == [30, 8, 8, 8, 6]
    np.testing.assert_array_equal(chunked.numpy(), one.numpy())
