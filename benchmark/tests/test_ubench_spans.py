"""The readers of the program's spans: over a short window of a tiny serve
cell and a tiny train cell on the CPU, each reads a finite value above 0
in its own kind of cell, and None in a cell of the other kind, where the
root span's count is not the window's units, or in a program without
spans. A stretch under the profiler after the window leaves them as the
window made them."""

import math
import sys

import pytest
import torch

from ubench_tiny import tiny_spec, harness

SERVE = ["copy_in_host_ms.serve", "dispatch_host_ms.serve", "copy_in_host_ms.flagship",
         "dispatch_host_ms.flagship"]
TRAIN = ["augment_host_ms.train", "forward_host_ms.train", "backward_host_ms.train",
         "update_host_ms.train"]
CELLS = {"c2-serve-700x16": ("serve", SERVE, TRAIN), "c2-train-recipe": ("train", TRAIN, SERVE)}


@pytest.fixture(scope="module", params=sorted(CELLS))
def window(request):
    """(cell name, the window's observation, the readings after it and
    after a traced stretch), of a tiny cell."""
    from unetseg_tpu_torch.ops.kernels.launches import reset_launch_counts

    spec = tiny_spec(request.param)
    cell = harness.kind_of(spec).Cell(spec, "cpu", 2**31 + 7)
    reset_launch_counts()
    obs = cell.observation(cell.window(0.2))
    names = SERVE + TRAIN
    before = {m: harness.metric_reader(m)(obs) for m in names}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        cell.traced()
    after = {m: harness.metric_reader(m)(obs) for m in names}
    return request.param, obs, before, after


def test_readers_read_their_own_cells_kind(window):
    cell, obs, before, _ = window
    kind, own, other = CELLS[cell]
    assert obs["kind"] == kind and obs["units"] >= 1
    for m in own:
        assert math.isfinite(before[m]) and before[m] > 0, m
    assert all(before[m] is None for m in other)


def test_the_traced_stretch_leaves_the_readings(window):
    _, _, before, after = window
    assert after == before


def test_none_where_the_root_count_is_not_the_units(window):
    cell, obs, _, _ = window
    for m in CELLS[cell][1]:
        assert harness.metric_reader(m)(dict(obs, units=obs["units"] + 1)) is None


def test_none_in_a_program_without_spans(window, monkeypatch):
    cell, obs, _, _ = window
    monkeypatch.setitem(sys.modules, "unetseg_tpu_torch.utils.profiling", None)
    for m in CELLS[cell][1]:
        assert harness.metric_reader(m)(obs) is None
