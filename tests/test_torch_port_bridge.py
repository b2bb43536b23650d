"""The port's parameter bridge and its copies of the JAX package's pure
Python modules, and the port's independence from jax."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from unetseg_tpu.core import config as jax_config
from unetseg_tpu.models import shapes as jax_shapes
from unetseg_tpu.models.unet import UNet as JaxUNet
from unetseg_tpu.models.unet import init_unet
from unetseg_tpu_torch.core import config
from unetseg_tpu_torch.models import shapes
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.models.unet import UNet
from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict, state_dict_to_flax


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("source", ["flax_init", "fast_init"])
def test_flax_tree_round_trip_is_bit_exact(source):
    cfg = config.ModelConfig(base_features=4)
    if source == "flax_init":
        v = init_unet(JaxUNet(cfg=jax_config.ModelConfig(base_features=4)),
                      jax.random.key(0), input_size=188)
    else:
        v = fast_random_variables(cfg, 0)
    sd = flax_to_state_dict(v)
    net = UNet(cfg)
    net.load_state_dict(sd)  # strict: every key and shape fits the port's UNet
    back = _leaves(state_dict_to_flax(net.state_dict()))
    want = _leaves(v)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == want[k].dtype and back[k].shape == want[k].shape, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["ModelConfig", "InferConfig", "DataConfig", "TrainConfig",
                                  "TrackConfig", "EvalConfig", "MeshConfig", "Config"])
def test_config_copies_match_the_originals(name):
    ours, orig = getattr(config, name), getattr(jax_config, name)
    strip = lambda fs: [(f.name, f.type, f.default) for f in fs]
    assert strip(dataclasses.fields(ours)) == strip(dataclasses.fields(orig))
    assert dataclasses.asdict(ours()) == dataclasses.asdict(orig())


def test_config_files_load_alike():
    root = Path(__file__).resolve().parents[1]
    for path in sorted((root / "configs").glob("*.json")):
        ours, orig = config.Config.from_json_file(path), jax_config.Config.from_json_file(path)
        assert ours.to_dict() == orig.to_dict(), path
        assert config.Config.from_dict(ours.to_dict()) == ours
    with pytest.raises(KeyError, match="unknown config key"):
        config.Config.from_dict({"train": {"no_such_field": 1}})


def test_shapes_copy_matches_the_original():
    for s in range(188, 761):
        for levels in (4, 5):
            try:
                want = jax_shapes.unet_shapes(s, levels)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    shapes.unet_shapes(s, levels)
                continue
            assert dataclasses.asdict(shapes.unet_shapes(s, levels)) == dataclasses.asdict(want)
    assert shapes.min_valid_input() == jax_shapes.min_valid_input() == 188
    assert shapes.center_crop_bounds(696, 520) == jax_shapes.center_crop_bounds(696, 520)


def test_port_imports_no_jax():
    """Nor Pillow: the GPU machine has none, and the port reads files with
    it only inside the functions that read them."""
    code = (
        "import sys\n"
        "import unetseg_tpu_torch, unetseg_tpu_torch.infer.engine, chip_smoke\n"
        "import unetseg_tpu_torch.train.steps, unetseg_tpu_torch.train.loop\n"
        "import unetseg_tpu_torch.cli.main, unetseg_tpu_torch.ops.weight_maps\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'unetseg_tpu', 'PIL'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
