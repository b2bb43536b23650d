"""utils/provenance.py and utils/profiling.py of the port, mirroring
tests/test_profiling.py, and recipe_hash against the JAX package's."""

import os

import torch

from unetseg_tpu.utils.provenance import recipe_hash as jax_recipe_hash
from unetseg_tpu_torch.utils.profiling import DeviceTimer, annotate, memory_stats, trace
from unetseg_tpu_torch.utils.provenance import REPO, recipe_hash


def test_device_timer_blocks():
    t = DeviceTimer()
    x = torch.ones(128, 128) @ torch.ones(128, 128)
    dt = t.stop(x, {"nested": [x]})
    assert dt > 0
    t.start()
    assert 0 < t.stop() < dt + 1.0


def test_annotate_and_trace_noop():
    with trace(None):
        with annotate("step"):
            torch.ones(4).sum()


def test_trace_writes_files(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        with annotate("double"):
            (torch.ones(64, 64) * 2).sum()
    files = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert files, "profiler wrote nothing"
    assert any(f.endswith(".pt.trace.json") for f in files)
    assert any('"double"' in open(f).read() for f in files)


def test_memory_stats_shape():
    s = memory_stats()
    assert len(s) == (torch.cuda.device_count() if torch.cuda.is_available() else 0)


def test_recipe_hash_equals_jax(tmp_path):
    assert recipe_hash() == jax_recipe_hash() != ""
    assert os.path.isfile(os.path.join(REPO, "configs", "best_recipe.json"))
    other = tmp_path / "r.json"
    other.write_text('{"model": {}}')
    assert recipe_hash(str(other)) == jax_recipe_hash(str(other))
    assert len(recipe_hash(str(other))) == 12
    assert recipe_hash(str(tmp_path / "missing.json")) == ""
