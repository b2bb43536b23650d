"""A configuration's whole `model` reaches the program: every cell builds the
ModelConfig it built when the harness passed a fixed tuple of eight keys; a
key that ModelConfig does not declare fails at load, naming the key and the
configuration; a field that ModelConfig gains reaches it from the file, and
takes its default where the file leaves it out."""

import dataclasses
import json

import pytest

from ubench_tiny import CELLS, ROOT, harness

EIGHT = ("in_channels", "num_classes", "base_features", "levels", "bilinear", "compute_dtype",
         "bn_momentum", "bn_epsilon")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_builds_the_model_config_it_built(cell):
    from unetseg_tpu_torch.core.config import ModelConfig

    model = harness.load_cell(cell, ROOT)["config"]["model"]
    assert harness.model_config(model) == ModelConfig(**{k: model[k] for k in EIGHT})


def root_with(tmp_path, model):
    """A checkout root whose BENCHMARK.json points unet-r15-c2 at a file
    holding `model` (the cells' traffic and limits stay the benchmark's)."""
    bench = harness.benchmark_json(ROOT)
    for c in bench["configs"]:
        if c["name"] == "unet-r15-c2":
            body = harness.read_json(ROOT / c["file"])
            c["file"] = "variant.json"
    (tmp_path / "variant.json").write_text(json.dumps(dict(body, model=model)))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_a_key_the_program_lacks_fails_at_load(tmp_path):
    model = dict(harness.read_json(ROOT / "benchmark/configs/unet-r15-c2.json")["model"],
                 attention_gates=True)
    with pytest.raises(ValueError, match=r"unet-r15-c2.*attention_gates"):
        harness.load_cell("c2-serve-700x16", root_with(tmp_path, model))


@dataclasses.dataclass(frozen=True)
class GatedConfig:
    """A stand-in for a ModelConfig that has gained a field."""

    in_channels: int = 1
    num_classes: int = 2
    base_features: int = 64
    levels: int = 5
    bilinear: bool = False
    compute_dtype: str = "bfloat16"
    bn_momentum: float = 0.9
    bn_epsilon: float = 1e-5
    attention_gates: bool = False


@pytest.mark.parametrize("named", [True, False])
def test_a_new_field_reaches_the_program(tmp_path, monkeypatch, named):
    from unetseg_tpu_torch.core import config

    monkeypatch.setattr(config, "ModelConfig", GatedConfig)
    model = {"in_channels": 1, "num_classes": 2, "base_features": 32, "levels": 4}
    if named:
        model["attention_gates"] = True
    spec = harness.load_cell("c2-serve-700x16", root_with(tmp_path, model))
    got = harness.model_config(spec["config"]["model"])
    assert got == GatedConfig(base_features=32, levels=4, attention_gates=named)
