"""The packed update route of train/state.py on the CPU, against the plain
per-leaf update (the kernels' arithmetic is held to the plain path on the
card in tests/test_torch_port_cuda.py).

On the CPU the state takes the plain route; the tests force the packed
route (`_flat_route`), where fused_update and fused_ema run their plain
versions over the packed buffers, so that what surrounds the kernels
(packing, views, host scalars, keeping states, resuming, the EMA's one
entry) is held bit for bit here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import unetseg_tpu_torch.train.state as state_mod
from unetseg_tpu_torch.core.config import ModelConfig, TrainConfig
from unetseg_tpu_torch.ops.kernels.update import (
    FlatLayout, FlatTensors, fused_ema, fused_update, is_packed, pack,
)
from unetseg_tpu_torch.train.state import Gradients, create_train_state
from unetseg_tpu_torch.train.steps import optax_global_norm

CFG = ModelConfig(base_features=4)
KINDS = {
    "sgd": dict(optimizer="sgd", momentum=0.99, learning_rate=0.05),
    "adam": dict(optimizer="adam", cosine_decay=True, learning_rate=3e-3),
    "adamw": dict(optimizer="adamw", cosine_decay=True, learning_rate=3e-3, weight_decay=0.01),
}
STEPS = 5


def _state(kind, ema):
    tcfg = TrainConfig(num_epochs=2, ema_decay=0.999 if ema else 0.0, **KINDS[kind])
    return create_train_state(0, CFG, tcfg, steps_per_epoch=3)


def _feed(state, n=STEPS):
    """n steps of seeded gradients (one channels-last leaf) and statistics."""
    g = torch.Generator().manual_seed(7)
    out = []
    for _ in range(n):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in state.params.items()}
        k4 = next(k for k, v in grads.items() if v.dim() == 4 and v.shape[1] > 1)
        grads[k4] = grads[k4].contiguous(memory_format=torch.channels_last)
        stats = {k: torch.rand(v.shape, generator=g) for k, v in state.batch_stats.items()}
        out.append((grads, stats))
    return out


def _trees(state):
    trees = {"params": state.params, "batch_stats": state.batch_stats,
             **{f"opt.{m}": state.opt_state[m] for m in state.tx.moments}}
    if state.ema_params is not None:
        trees.update(ema_params=state.ema_params, ema_batch_stats=state.ema_batch_stats)
    return trees


def _snapshot(state):
    return {n: {k: v.clone() for k, v in t.items()} for n, t in _trees(state).items()}


def _assert_equal(got, want, what):
    assert got.step == want.step and got.opt_state["count"] == want.opt_state["count"], what
    a, b = _trees(got), _trees(want)
    assert a.keys() == b.keys(), what
    for n in a:
        assert list(a[n]) == list(b[n]), f"{what} {n} keys"
        for k in a[n]:
            assert torch.equal(a[n][k], b[n][k]), f"{what} {n} {k}"


def _run(state, feed, packed=True):
    states, norms = [], []
    for grads, stats in feed:
        g = Gradients(grads)
        state = state.apply_gradients(g, stats)
        states.append(state)
        norms.append(optax_global_norm(g))
        assert (g.global_norm is not None) == packed
    return states, norms


@pytest.mark.parametrize("ema", [False, True], ids=["no_ema", "ema"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_packed_route_equals_the_plain_update(kind, ema, monkeypatch):
    state0 = _state(kind, ema)
    assert not state_mod._flat_route(state0.params)  # the CPU's own route is plain
    feed = _feed(state0)
    plain, plain_norms = _run(state0, feed, packed=False)

    # the packed route: the same bits, every tree packed once at the first step
    packs = []
    real_pack = state_mod.pack
    monkeypatch.setattr(state_mod, "pack", lambda t, *a: packs.append(1) or real_pack(t, *a))
    monkeypatch.setattr(state_mod, "_flat_route", lambda tree: True)
    before = _snapshot(state0)
    states, norms = _run(state0, feed)
    n_trees = 1 + len(state0.tx.moments) + (2 if ema else 0)
    assert len(packs) == n_trees  # later steps find every tree packed
    for i, (got, want) in enumerate(zip(states, plain)):
        _assert_equal(got, want, f"{kind} step {i}")
        for n, t in _trees(got).items():
            assert is_packed(t) == (n != "batch_stats"), n
        assert is_packed(got.params, got.opt_state[got.tx.moments[0]].layout)
    for a, b in zip(norms, plain_norms):
        assert torch.equal(a, b)

    # a kept state does not change while later steps run: each state above
    # was compared after all STEPS had run, and so is the first one here
    for n, t in _trees(state0).items():
        for k, v in t.items():
            assert torch.equal(v, before[n][k]), f"kept state0 {n} {k}"

    # a state resumed unpacked (fresh dicts, as a checkpoint restores it)
    # continues bit for bit
    mid = states[1]
    unpacked = dataclasses.replace(
        mid, params={k: v.clone() for k, v in mid.params.items()},
        opt_state={"count": mid.opt_state["count"],
                   **{m: {k: v.clone() for k, v in mid.opt_state[m].items()}
                      for m in mid.tx.moments}},
        ema_params=None if mid.ema_params is None else {k: v.clone()
                                                        for k, v in mid.ema_params.items()},
        ema_batch_stats=None if mid.ema_batch_stats is None else dict(mid.ema_batch_stats))
    assert not is_packed(unpacked.params)
    resumed, _ = _run(unpacked, feed[2:])
    for i, (got, want) in enumerate(zip(resumed, states[2:])):
        _assert_equal(got, want, f"{kind} resumed step {i + 2}")

    # the benchmark's `ema` fault patches train.state._ema; on the packed
    # route it still takes effect, and only on the shadows
    def faulty_apply(self, grads, batch_stats, orig=state_mod.TrainState.apply_gradients):
        ema = state_mod._ema
        state_mod._ema = lambda shadow, new, d: ema(shadow, new, self.ema_decay)
        try:
            return orig(self, grads, batch_stats)
        finally:
            state_mod._ema = ema

    monkeypatch.setattr(state_mod.TrainState, "apply_gradients", faulty_apply)
    faulty, _ = _run(state0, feed[:2])
    assert all(torch.equal(faulty[1].params[k], v) for k, v in states[1].params.items())
    if ema:
        assert not all(torch.equal(faulty[1].ema_params[k], v)
                       for k, v in states[1].ema_params.items())
        assert not all(torch.equal(faulty[1].ema_batch_stats[k], v)
                       for k, v in states[1].ema_batch_stats.items())
    else:
        assert faulty[1].ema_params is None


def test_gradient_norm_is_the_plain_one_on_the_plain_route():
    g = {"a": torch.tensor([3.0, 0.0]), "b": torch.tensor([[4.0]])}
    assert optax_global_norm(g).item() == 5.0
    tagged = Gradients(g)
    tagged.global_norm = torch.tensor(1.0)
    assert optax_global_norm(tagged).item() == 1.0  # the norm the update left


def test_layout_aligns_leaves_and_is_shared_by_equal_trees():
    tree = {"w": torch.zeros(3, 5), "b": torch.zeros(2), "v": torch.zeros(4, 1, 2)}
    layout = FlatLayout.of(tree)
    assert layout is FlatLayout.of({k: torch.ones_like(v) for k, v in tree.items()})
    assert layout.offsets == (0, 128, 256) and layout.size == 384
    assert layout.numels == (15, 2, 8) and layout.blocks == 3
    assert FlatLayout.of(dict(reversed(list(tree.items())))) is not layout


@pytest.mark.parametrize("mutate", [
    lambda d: d.__setitem__("b", torch.zeros(2)),
    lambda d: d.__delitem__("b"),
    lambda d: d.pop("b"),
    lambda d: d.popitem(),
    lambda d: d.update(b=torch.zeros(2)),
    lambda d: d.setdefault("c", torch.zeros(1)),
    lambda d: d.clear(),
    lambda d: d.__ior__({"b": torch.zeros(2)}),
], ids=["setitem", "delitem", "pop", "popitem", "update", "setdefault", "clear", "ior"])
def test_a_changed_packed_dict_is_packed_anew(mutate):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.tensor([1.0, 2.0])}
    flat = pack(tree)
    assert is_packed(flat) and isinstance(flat, FlatTensors)
    for k, off in zip(tree, flat.layout.offsets):
        assert torch.equal(flat[k], tree[k]) and flat[k].is_contiguous()
        assert flat[k].data_ptr() == flat.flat.data_ptr() + 4 * off
    mutate(flat)
    assert not is_packed(flat)


def test_pack_refuses_what_the_layout_does_not_hold():
    layout = FlatLayout.of({"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        pack({"w": torch.zeros(3, 2)}, layout)
    with pytest.raises(ValueError, match="leaves"):
        pack({"w": torch.zeros(2, 3), "b": torch.zeros(1)}, layout)
    with pytest.raises(TypeError, match="float32"):
        pack({"w": torch.zeros(2, 3, dtype=torch.bfloat16)})


def test_wrappers_refuse_unpacked_state_and_count_no_cpu_launch():
    p = pack({"w": torch.ones(2, 3)})
    g = {"w": torch.ones(2, 3)}
    h = state_mod.Optimizer("sgd", 0.1).scalars(0)
    with pytest.raises(ValueError, match="packed"):
        fused_update("sgd", {"w": torch.ones(2, 3)}, g, [pack({"w": torch.zeros(2, 3)})], h)
    with pytest.raises(ValueError, match="moments"):
        fused_update("adam", p, g, [pack({"w": torch.zeros(2, 3)}, p.layout)], h)
    with pytest.raises(ValueError, match="packed"):
        fused_ema({"w": torch.ones(2, 3)}, g, 0.5)
    before = (fused_update.launches, fused_ema.launches)
    new_p, (tr,), norm = fused_update("sgd", p, g, [pack({"w": torch.zeros(2, 3)}, p.layout)], h)
    assert torch.equal(tr["w"], g["w"]) and torch.allclose(new_p["w"], torch.full((2, 3), 0.9))
    assert norm.item() == pytest.approx(6 ** 0.5)
    e = fused_ema(p, new_p, 0.5)
    assert torch.allclose(e["w"], torch.full((2, 3), 0.95))
    assert torch.equal(p["w"], torch.ones(2, 3))  # the inputs are left as they were
    assert (fused_update.launches, fused_ema.launches) == before


def test_host_scalars_need_no_device():
    """The bias corrections' reciprocals are f32 values computed on the
    host; the rate follows the schedule's count."""
    opt = state_mod.make_optimizer(TrainConfig(optimizer="adam", cosine_decay=True,
                                               learning_rate=1e-3, num_epochs=1), 4)
    h = opt.scalars(0)
    assert h.inv_c1 == pytest.approx(10, rel=1e-6) and h.inv_c2 == pytest.approx(1e3, rel=1e-4)
    assert float(torch.tensor(h.inv_c1, dtype=torch.float32)) == h.inv_c1  # an f32 value
    assert h.step == -1e-3 and opt.scalars(4).step == pytest.approx(0.0, abs=1e-12)
    pw = state_mod._f32_pow(0.9, 3)
    assert pw.dtype == np.float32 and pw == pytest.approx(0.729, rel=1e-6)
