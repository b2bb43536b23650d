"""benchmark/flops.py against sums a reader can check by hand."""

import pytest

from ubench_parent import CONFIGS, RECORDED
from ubench_tiny import ROOT, harness

import flops

UNET = {"in_channels": 1, "num_classes": 2, "base_features": 64, "levels": 5}
ARCH = harness.architecture_of({})


def macs_572():
    """The paper's Fig. 1 net at 572^2 (388^2 out), layer by layer:
    outputs^2 x in x out x taps."""
    enc = [570**2 * 1 * 64 * 9, 568**2 * 64 * 64 * 9,
           282**2 * 64 * 128 * 9, 280**2 * 128 * 128 * 9,
           138**2 * 128 * 256 * 9, 136**2 * 256 * 256 * 9,
           66**2 * 256 * 512 * 9, 64**2 * 512 * 512 * 9,
           30**2 * 512 * 1024 * 9, 28**2 * 1024 * 1024 * 9]
    dec = [56**2 * 1024 * 512, 54**2 * 1024 * 512 * 9, 52**2 * 512 * 512 * 9,
           104**2 * 512 * 256, 102**2 * 512 * 256 * 9, 100**2 * 256 * 256 * 9,
           200**2 * 256 * 128, 198**2 * 256 * 128 * 9, 196**2 * 128 * 128 * 9,
           392**2 * 128 * 64, 390**2 * 128 * 64 * 9, 388**2 * 64 * 64 * 9]
    return sum(enc) + sum(dec) + 388**2 * 64 * 2


def test_paper_net_572():
    assert flops.shapes(572, 5)["out"] == 388
    layers = ARCH.forward_layers(UNET, 1, 572)
    assert flops.model_flops(layers) == 2 * macs_572()
    # batch scales every count
    assert flops.model_flops(ARCH.forward_layers(UNET, 3, 572)) == 6 * macs_572()


@pytest.mark.parametrize("tile,out", [(700, 516), (512, 324), (252, 68), (188, 4)])
def test_tile_outputs(tile, out):
    assert flops.shapes(tile, 5)["out"] == out


def test_tiles_of_the_serving_cells():
    assert flops.tile_grid(512, 700, 5) == {"tile_out": 516, "per_side": 1, "tiles": 1}
    assert flops.tile_grid(512, 512, 5) == {"tile_out": 324, "per_side": 2, "tiles": 4}
    serve = harness.read_json(ROOT / "benchmark/traffic/serve-700x16.json")
    flag = harness.read_json(ROOT / "benchmark/traffic/serve-flagship.json")
    one = flops.serve_call(ARCH, UNET, serve)
    assert one["forwards"] == 1
    assert one["model_flops"] == flops.model_flops(ARCH.forward_layers(UNET, 16, 700))
    many = flops.serve_call(ARCH, UNET, flag)
    assert many["forwards"] == 3 * 4 * 4  # members x flips x chunks of 8 of 32 tiles
    assert many["model_flops"] == 48 * flops.model_flops(ARCH.forward_layers(UNET, 8, 512))


def test_a_layers_bound_is_its_slower_limit():
    conv = ARCH.forward_layers(UNET, 16, 700)[1]  # enc0.conv1 at 698^2 -> 696^2
    assert conv["name"] == "enc0.conv1"
    assert conv["ops"] == 2 * 16 * 696**2 * 64 * 64 * 9
    assert conv["bytes"] == (16 * 698**2 * 64 * 2 + 9 * 64 * 64 * 2 + 64 * 4
                             + 16 * 696**2 * 64 * 2)
    assert conv["bound_s"] == max(conv["ops"] / 989e12, conv["bytes"] / 3.35e12)


@pytest.mark.parametrize("name", CONFIGS)
def test_param_count_is_the_papers_net(name):
    from unetseg_tpu_torch.core.config import ModelConfig
    from unetseg_tpu_torch.models.unet import UNet, param_count

    model = harness.read_json(ROOT / "benchmark" / "configs" / f"{name}.json")["model"]
    n = flops.param_count(ARCH, model)
    assert n == RECORDED[f"{name}/param_count"]
    assert n["params"] == param_count(UNet(ModelConfig(num_classes=model["num_classes"])))
    assert flops.param_count(ARCH, UNET)["params"] == 31_042_434


def test_train_step_counts_three_passes_less_the_stem_dgrad():
    fwd = ARCH.forward_layers(UNET, 4, 512)
    stem = next(x for x in fwd if x["name"] == "enc0.conv0")
    step = flops.train_step(ARCH, UNET, {"batch": 4, "size": 512, "elastic_sigma": 20.0})
    assert step["model_flops"] == 3 * flops.model_flops(fwd) - stem["ops"]
    aug = next(x for x in step["layers"] if x["name"] == "augment")
    # two fields an item, blurred by 2 x 80 + 1 taps along each of two axes
    assert aug["ops"] == 2 * 4 * 2 * 2 * 161 * 512**2 + 30 * 4 * 512**2
