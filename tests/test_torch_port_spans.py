"""The port's spans (utils/profiling.annotate): host-clock totals with the
profiler off, trace regions with it on, the reset through
reset_launch_counts, and the serve.* and train.* spans of masks_tiled and
the train step on a tiny CPU net (base 4, float32), whose phases cover
their root in the trace."""

import glob
import json
import os
import types

import numpy as np
import pytest
import torch

from unetseg_tpu_torch.core.config import InferConfig, ModelConfig, TrainConfig
from unetseg_tpu_torch.infer.engine import Predictor
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.ops.kernels.launches import reset_launch_counts
from unetseg_tpu_torch.train.state import create_train_state
from unetseg_tpu_torch.train.steps import make_epoch_train_step, make_train_step
from unetseg_tpu_torch.utils import profiling
from unetseg_tpu_torch.utils.profiling import annotate, reset_span_totals, span_totals

TINY = ModelConfig(base_features=4, compute_dtype="float32")
S = 188  # the smallest valid input: output 4x4
SERVE = ("serve.copy_in", "serve.dispatch", "serve.copy_out")
TRAIN = ("train.augment", "train.forward", "train.backward", "train.update")


def fake_clock(monkeypatch, ticks):
    """Make the spans read `ticks` (ns), in order, from their clock."""
    it = iter(ticks)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(it), perf_counter=profiling.time.perf_counter))


def regions(trace_dir):
    """The user_annotation events of the one chrome trace in `trace_dir`."""
    (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def traced(trace_dir, fn, *args):
    """fn(*args) under profiling.trace(trace_dir), after a first region
    that takes the session's one-time cost of its first region."""
    with profiling.trace(trace_dir):
        with annotate("profiler warm-up"):
            pass
        fn(*args)


def inside(outer, events):
    """The events other than `outer` that lie within its interval."""
    end = outer["ts"] + outer["dur"]
    return [e for e in events if e is not outer and outer["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= end + 1e-3]


def test_timed_spans_count_totals_and_self_times(monkeypatch):
    # outer 0-100 holds inner 10-30 and inner 40-45; a lone span 200-207
    fake_clock(monkeypatch, [0, 10, 30, 40, 45, 100, 200, 207])
    emitted = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: emitted.append(name))
    reset_span_totals()
    with annotate("outer"):
        with annotate("inner"):
            pass
        with annotate("inner"):
            pass
    with annotate("lone"):
        pass
    got = {k: (v["count"], round(v["total_s"] * 1e9), round(v["self_s"] * 1e9))
           for k, v in span_totals().items()}
    assert got == {"outer": (1, 100, 75), "inner": (2, 25, 25), "lone": (1, 7, 7)}
    assert emitted == []


def test_a_span_that_raises_is_timed_and_unwinds(monkeypatch):
    fake_clock(monkeypatch, [0, 5, 9, 20])
    reset_span_totals()
    with pytest.raises(ValueError):
        with annotate("outer"):
            with annotate("inner"):
                raise ValueError("inner")
    totals = span_totals()
    assert totals["inner"]["count"] == 1 and round(totals["inner"]["total_s"] * 1e9) == 4
    assert round(totals["outer"]["self_s"] * 1e9) == 16
    assert profiling._OPEN.stack == []


def test_spans_under_the_profiler_are_regions_and_add_nothing(tmp_path):
    reset_span_totals()
    with profiling.trace(str(tmp_path)):
        with annotate("outer"):
            with annotate("inner"):
                (torch.ones(32, 32) * 2).sum()
    assert span_totals() == {}
    ev = regions(str(tmp_path))
    (outer,) = [e for e in ev if e["name"] == "outer"]
    assert [e["name"] for e in inside(outer, ev)] == ["inner"]


def test_reset_launch_counts_clears_the_span_totals():
    with annotate("x"):
        pass
    assert span_totals()["x"]["count"] >= 1
    reset_launch_counts()
    assert span_totals() == {}


def covered(trace_dir, root, children):
    """Each `root` region holds each of `children` once; returns the least
    share of a root's duration that its children cover."""
    ev = regions(trace_dir)
    roots = [e for e in ev if e["name"] == root]
    assert roots
    shares = []
    for r in roots:
        kids = [e for e in inside(r, ev) if e["name"] in children]
        assert sorted(e["name"] for e in kids) == sorted(children)
        shares.append(sum(e["dur"] for e in kids) / r["dur"])
    return min(shares)


def test_masks_tiled_spans(tmp_path):
    p = Predictor(TINY, fast_random_variables(TINY, 0), InferConfig(tile_input=252, tile_batch=4),
                  "cpu")
    frames = np.random.RandomState(0).rand(2, 64, 64).astype(np.float32)
    want = p.masks_tiled(frames)
    reset_span_totals()
    np.testing.assert_array_equal(p.masks_tiled(frames), want)
    totals = span_totals()
    assert {k: v["count"] for k, v in totals.items()} == dict.fromkeys(("serve.call",) + SERVE, 1)
    kids = sum(totals[k]["total_s"] for k in SERVE)
    assert kids <= totals["serve.call"]["total_s"]
    assert totals["serve.call"]["self_s"] == pytest.approx(totals["serve.call"]["total_s"] - kids)
    traced(str(tmp_path), p.masks_tiled, frames)
    assert covered(str(tmp_path), "serve.call", SERVE) >= 0.95
    assert span_totals() == totals


def _train_inputs(n, seed):
    rs = np.random.RandomState(seed)
    masks = torch.from_numpy((rs.rand(n, S, S) > 0.5).astype(np.int32))
    images = torch.from_numpy(rs.rand(n, S, S).astype(np.float32))
    weights = torch.from_numpy(rs.uniform(1, 3, (n, S, S)).astype(np.float32))
    return images, masks, weights, torch.ones(n, dtype=torch.bool)


@pytest.mark.parametrize("three_class", [False, True])
def test_train_step_spans(tmp_path, three_class):
    cfg = ModelConfig(base_features=4, compute_dtype="float32", num_classes=3 if three_class else 2)
    state = create_train_state(fast_random_variables(cfg, 0), cfg,
                               TrainConfig(optimizer="adam", ema_decay=0.999), input_size=S,
                               steps_per_epoch=4, device="cpu")
    step = make_train_step(cfg, augment=True, three_class=three_class, standardize=True,
                           aug_gamma=0.3, aug_noise=0.05)
    batch = _train_inputs(2, 1)
    gen = torch.Generator().manual_seed(0)
    reset_span_totals()
    state, _ = step(state, *batch, gen)
    totals = span_totals()
    assert {k: v["count"] for k, v in totals.items()} == dict.fromkeys(("train.step",) + TRAIN, 1)
    assert sum(totals[k]["total_s"] for k in TRAIN) <= totals["train.step"]["total_s"]
    traced(str(tmp_path), step, state, *batch, gen)
    assert covered(str(tmp_path), "train.step", TRAIN) >= 0.95
    assert span_totals() == totals


def test_the_epoch_feed_carries_the_train_spans():
    state = create_train_state(fast_random_variables(TINY, 0), TINY, TrainConfig(), input_size=S,
                               steps_per_epoch=2, device="cpu")
    epoch_step = make_epoch_train_step(TINY, augment=False)
    images, masks, weights, _ = _train_inputs(4, 2)
    idx = torch.tensor([[0, 1], [2, 3]])
    reset_span_totals()
    epoch_step(state, images, masks, weights, idx, torch.ones(2, 2, dtype=torch.bool))
    assert {k: v["count"] for k, v in span_totals().items()} == dict.fromkeys(
        ("train.step",) + TRAIN, 2)
