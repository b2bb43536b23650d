"""The port's module-level surface against the JAX package's.

Every public top-level function, class and UPPER_CASE constant of every
module of `unetseg_tpu/` outside `ops/pallas/`, and every public method
of `core/config.Config`, read from the source with `ast` (so the walk
imports no JAX module), has a same-named counterpart in the port's
module of that path (`lanes_net` -> `kernel_net`, `lanes_train` ->
`train_forward`), or an entry with its reason in NO_COUNTERPART; an
entry whose name the port has fails. The names ported for that walk are
then held to the JAX functions on seeded inputs: `Config.replace` /
`to_json` both ways, the checkpoint helpers over a saved tiny state,
`cropped_weighted_ce`, `sample_2d` and `host_put_tree`.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "unetseg_tpu"
RENAMED = {"lanes_net": "kernel_net", "lanes_train": "train_forward"}

_PACKED = ("ops/packed_conv.py: the width-packed 3x3 conv, two pixels' channels in one "
           "128-lane vector to fill the TPU's lanes at 64 channels; on the card the "
           "64-channel convs are the wgmma kernels of csrc/conv_fwd_wgmma.cu")
_BN_LANES = ("a BN+ReLU custom VJP over the TPU lanes layouts of models/lanes_train.py; the "
             "port's fused BN (ops/fused_bn.py bn_relu_nhwc) takes the NHWC tensors its "
             "kernels produce, for both tiers")
# (JAX module path under unetseg_tpu/, name) -> why the port has no same-named counterpart
NO_COUNTERPART = {
    ("infer/folding.py", "PackableConv3x3"):
        "a Flax conv that switches to ops/packed_conv's width-packed form; the port's "
        "folded net (FoldedUNet) runs plain convs and the kernels",
    ("infer/lanes_net.py", "folded_forward_tier1"):
        "the lanes-layout forward with its TPU switches (mid_hcnw, fuse_dec_entry); the "
        "port's counterpart is infer/kernel_net.folded_forward_kernels, whose keyword "
        "arguments are the serving variants",
    ("models/lanes_train.py", "make_tconv_p2_train"):
        "a custom VJP of the phase-2 tconv over item strides of the lanes layout; the port's "
        "train tconv is ops/kernels/conv3x3_train's autograd Function over NCHW",
    ("models/lanes_train.py", "train_forward_lanes"):
        "renamed: models/train_forward.train_forward (the kernel train forward, tiers 1 and 2)",
    ("models/unet.py", "MaskedBatchNorm"):
        "a Flax module; the port's UNet holds nn.BatchNorm2d, and the masked statistics are "
        "the function models/unet.masked_batch_norm (fused with the ReLU: ops/fused_bn)",
    ("models/unet.py", "init_unet"):
        "Flax's model.init over a dummy batch; the port's UNet(cfg) holds its parameters "
        "from construction, and seeded variable trees come from models/fast_init",
    ("ops/fused_bn.py", "make_bn_relu_p2"): _BN_LANES,
    ("ops/fused_bn.py", "make_bn_relu_dense"): _BN_LANES,
    ("ops/fused_bn.py", "make_bn_relu_nhwc"): _BN_LANES,
    ("ops/weight_maps.py", "MAX_INSTANCES"):
        "the JAX package's cap, its largest static instance bucket; the port takes any "
        "instance count, its EDTs batched by EDT_CHUNK",
    ("parallel/sharding.py", "make_sharded_tile_forward"):
        "a GSPMD-sharded jit of the tile forward; Predictor(mesh=) shards the tiles over the "
        "ranks (infer/tiling.shard_tile_fn)",
    ("parallel/sharding.py", "replicate_state"):
        "places a TrainState on every device of a jax mesh; each port rank builds its own "
        "replica from the same seed on its device (create_train_state(device=mesh.device))",
    ("train/steps.py", "REMAT_POLICIES"):
        "jax.checkpoint policies of TrainConfig.remat; the port has no remat (the step fits "
        "the card's memory), and its loop ignores the field",
    ("ops/packed_conv.py", "pack_width"): _PACKED,
    ("ops/packed_conv.py", "unpack_width"): _PACKED,
    ("ops/packed_conv.py", "pack_kernel_3x3"): _PACKED,
    ("ops/packed_conv.py", "packed_conv3x3_valid"): _PACKED,
    ("ops/packed_conv.py", "should_pack"): _PACKED,
}


def public_names(tree: ast.Module):
    """Public top-level functions, classes and UPPER_CASE constants."""
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for e in ([t] if isinstance(t, ast.Name) else getattr(t, "elts", [])):
                    if isinstance(e, ast.Name) and e.id.isupper():
                        out.append(e.id)
    return [n for n in out if not n.startswith("_")]


def class_methods(tree: ast.Module, cls: str):
    node = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls)
    return [n.name for n in node.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")]


def jax_surface():
    """{module path under unetseg_tpu/: its public names}, read with ast."""
    out = {}
    for path in sorted(JAX_ROOT.glob("**/*.py")):
        rel = path.relative_to(JAX_ROOT).as_posix()
        if not rel.startswith("ops/pallas/"):
            out[rel] = public_names(ast.parse(path.read_text()))
    return out


def port_module(rel: str) -> str:
    parts = list(Path(rel).with_suffix("").parts)
    parts[-1] = RENAMED.get(parts[-1], parts[-1])
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(["unetseg_tpu_torch", *parts])


def port_has(rel: str, name: str) -> bool:
    try:
        mod = importlib.import_module(port_module(rel))
    except ModuleNotFoundError:
        return False
    return hasattr(mod, name)


SURFACE = jax_surface()


@pytest.mark.parametrize("rel", sorted(SURFACE))
def test_every_public_name_has_a_counterpart(rel):
    names = SURFACE[rel]
    missing = [n for n in names if (rel, n) not in NO_COUNTERPART and not port_has(rel, n)]
    assert not missing, f"unetseg_tpu/{rel}: {missing} missing from {port_module(rel)}"
    if not names:  # a module with no public names still has its counterpart module
        path = REPO / Path(*port_module(rel).split("."))
        assert path.with_suffix(".py").is_file() or (path / "__init__.py").is_file(), rel


def test_config_methods_have_counterparts():
    from unetseg_tpu_torch.core.config import Config

    jax_methods = class_methods(ast.parse((JAX_ROOT / "core/config.py").read_text()), "Config")
    assert {"replace", "to_dict", "to_json", "from_dict", "from_json_file"} <= set(jax_methods)
    assert [m for m in jax_methods if not hasattr(Config, m)] == []


@pytest.mark.parametrize("entry", sorted(NO_COUNTERPART), ids="{0[0]}:{0[1]}".format)
def test_no_counterpart_entries_are_live(entry):
    """Each entry names a public JAX name the port still lacks, with a reason."""
    rel, name = entry
    assert name in SURFACE.get(rel, []), f"{rel} has no public {name}"
    assert not port_has(rel, name), f"{port_module(rel)} now has {name}: drop the entry"
    assert len(NO_COUNTERPART[entry]) > 20


def test_the_walk_imports_no_jax():
    code = (f"import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('surface', {str(Path(__file__))!r})\n"
            f"mod = importlib.util.module_from_spec(spec)\n"
            f"spec.loader.exec_module(mod)\n"
            f"n = sum(map(len, mod.jax_surface().values()))\n"
            f"print(n, sorted(m for m in sys.modules if m.split('.')[0] in "
            f"('jax', 'flax', 'unetseg_tpu')))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    count, loaded = r.stdout.split(" ", 1)
    assert int(count) > 200 and loaded.strip() == "[]"


# ------------------------------------------------------------------ Config
def _configs():
    from unetseg_tpu.core import config as jc
    from unetseg_tpu_torch.core import config as pc

    return jc.Config, pc.Config


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config_json_loads_in_both_packages(tmp_path, writer):
    """A config changed through replace, written by one package's to_json,
    loads in both packages' from_json_file to the same fields."""
    JaxConfig, PortConfig = _configs()
    cls = JaxConfig if writer == "jax" else PortConfig
    base = cls()
    cfg = base.replace(
        model=dataclasses.replace(base.model, base_features=8, compute_dtype="float32"),
        train=dataclasses.replace(base.train, num_epochs=3, ema_decay=0.999),
        infer=dataclasses.replace(base.infer, tta="flips", ensemble_merge="vote"),
        infer_per_sequence={"02": {"boundary_grow": 1.5}})
    assert cfg.model.base_features == 8 and base.model.base_features == 64
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    a, b = JaxConfig.from_json_file(str(path)), PortConfig.from_json_file(str(path))
    assert a.to_dict() == b.to_dict() == cfg.to_dict()
    assert a.to_json() == b.to_json() == cfg.to_json()
    assert json.loads(cfg.to_json(indent=None)) == cfg.to_dict()


# ------------------------------------------------------------- checkpoints
TINY = dict(base_features=4, compute_dtype="float32")


def _variables(seed):
    from unetseg_tpu_torch.core.config import ModelConfig
    from unetseg_tpu_torch.models.fast_init import fast_random_variables

    return fast_random_variables(ModelConfig(**TINY), seed)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The same seeded tiny state (raw weights of seed 3, an EMA shadow of
    seed 13) saved by both packages' save_checkpoint at epochs 0 and 1
    (keep 3), and a state without EMA saved by each; returns the dirs, the
    saved config and the port state."""
    import jax
    from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
    from unetseg_tpu.train import checkpoint as jck
    from unetseg_tpu_torch.core.config import Config, ModelConfig, TrainConfig
    from unetseg_tpu_torch.train import checkpoint as pck
    from unetseg_tpu_torch.train.state import create_train_state
    from unetseg_tpu_torch.models.unet import split_state_dict
    from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict

    sys.path.insert(0, str(REPO / "tools"))
    try:
        from jax_checkpoint_to_torch import restore_template
    finally:
        sys.path.remove(str(REPO / "tools"))

    raw, shadow = _variables(3), _variables(13)
    jax_state = restore_template(JaxModelConfig(**TINY)).replace(
        params=jax.tree.map(np.asarray, raw["params"]), batch_stats=raw["batch_stats"],
        ema_params=shadow["params"], ema_batch_stats=shadow["batch_stats"])
    state = create_train_state(raw, ModelConfig(**TINY), TrainConfig(ema_decay=0.999),
                               steps_per_epoch=1, device="cpu")
    ema_p, ema_s = split_state_dict(flax_to_state_dict(shadow))
    state = dataclasses.replace(state, ema_params=ema_p, ema_batch_stats=ema_s)
    plain = create_train_state(raw, ModelConfig(**TINY), TrainConfig(), steps_per_epoch=1,
                               device="cpu")
    config = Config().replace(model=ModelConfig(**TINY)).to_dict()
    root = tmp_path_factory.mktemp("ckpt")
    dirs = {k: str(root / k) for k in ("jax", "port", "jax_plain", "port_plain")}
    for epoch, loss in ((0, 0.5), (1, 0.75)):
        extra = {"config": config, "epoch_seen": epoch}
        jck.save_checkpoint(dirs["jax"], jax_state, epoch, loss, keep=3, extra=extra)
        pck.save_checkpoint(dirs["port"], state, epoch, loss, keep=3, extra=extra)
    jck.save_checkpoint(dirs["jax_plain"], jax_state.replace(ema_params=None,
                                                              ema_batch_stats=None), 0, 0.5)
    pck.save_checkpoint(dirs["port_plain"], plain, 0, 0.5)
    return dirs, config, state, jax_state


def _flax(params, stats):
    from unetseg_tpu_torch.utils.flax_bridge import state_dict_to_flax

    return state_dict_to_flax({**params, **stats})


def _assert_trees_equal(a, b):
    import jax

    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32),
                                      err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("ema", [False, True])
def test_restore_light_equals_the_saved_state_and_jax(saved, ema):
    from unetseg_tpu.train import checkpoint as jck
    from unetseg_tpu_torch.train import checkpoint as pck

    dirs, _, state, jax_state = saved
    src_p = state.ema_params if ema else state.params
    src_s = state.ema_batch_stats if ema else state.batch_stats
    params, stats, extra = pck.restore_light(dirs["port"], state.params, state.batch_stats,
                                             ema=ema)
    assert extra["epoch_seen"] == 1  # the latest epoch, as the JAX helper picks it
    assert all(v.dtype == torch.float32 for v in params.values())
    for k, v in src_p.items():  # the light stream keeps bf16 params
        torch.testing.assert_close(params[k], v.to(torch.bfloat16).float(), rtol=0, atol=0)
    for k, v in src_s.items():
        torch.testing.assert_close(stats[k], v, rtol=0, atol=0)
    jp, js, jextra = jck.restore_light(dirs["jax"], jax_state.params, jax_state.batch_stats,
                                       ema=ema)
    _assert_trees_equal(_flax(params, stats), {"params": jp, "batch_stats": js})
    assert jextra == extra
    # no template: the same values, on the CPU
    again = pck.restore_light(dirs["port"], epoch=0, ema=ema)
    assert again[2]["epoch_seen"] == 0
    assert all(torch.equal(again[0][k], params[k]) for k in params)


def test_restore_light_refusals(saved):
    from unetseg_tpu.train import checkpoint as jck
    from unetseg_tpu_torch.train import checkpoint as pck

    dirs, _, state, jax_state = saved
    with pytest.raises(FileNotFoundError, match="no EMA shadow"):
        pck.restore_light(dirs["port_plain"], ema=True)
    with pytest.raises(FileNotFoundError, match="no EMA shadow"):
        jck.restore_light(dirs["jax_plain"], jax_state.params, jax_state.batch_stats, ema=True)
    with pytest.raises(KeyError, match="differ from the template"):
        pck.restore_light(dirs["port"], {"enc0.conv0.weight": state.params["enc0.conv0.weight"]},
                          state.batch_stats)
    with pytest.raises(FileNotFoundError):
        pck.restore_light(str(Path(dirs["port"]) / "absent"))


def test_read_checkpoint_config_and_latest_epochs(saved):
    from unetseg_tpu.train import checkpoint as jck
    from unetseg_tpu_torch.train import checkpoint as pck

    dirs, config, _, _ = saved
    assert pck.read_checkpoint_config(dirs["port"]) == config
    assert jck.read_checkpoint_config(dirs["jax"]) == config
    assert pck.read_checkpoint_config(dirs["port"], epoch=0) == config
    assert pck.read_checkpoint_config(dirs["port_plain"]) == {} == jck.read_checkpoint_config(
        dirs["jax_plain"])
    for d in ("", "_plain"):
        assert pck.light_latest_epoch(dirs["port" + d]) == jck.light_latest_epoch(dirs["jax" + d])
        assert pck.best_epoch(dirs["port" + d]) == jck.best_epoch(dirs["jax" + d]) == 0
    assert pck.light_latest_epoch(dirs["port"]) == 1
    assert pck.light_latest_epoch(str(Path(dirs["port"]) / "absent")) is None
    # save_checkpoint wrote the full stream too: the resume artifact
    assert pck.latest_epoch(dirs["port"]) == jck.latest_epoch(dirs["jax"]) == 1


def test_light_payload_is_a_host_copy(saved):
    from unetseg_tpu.train import checkpoint as jck
    from unetseg_tpu_torch.train import checkpoint as pck

    _, _, state, jax_state = saved
    payload = pck.light_payload(state)
    assert set(payload) == {"params", "batch_stats", "ema"}
    assert all(v.dtype == torch.bfloat16 and v.device.type == "cpu"
               for v in payload["params"].values())
    k = "enc0.conv0.weight"
    payload["params"][k].zero_()  # a copy: the state is untouched
    assert state.params[k].abs().sum() > 0
    jp = jck.light_payload(jax_state)
    port = pck.light_payload(state)
    ema_params = {k: v.float() for k, v in port["ema"]["params"].items()}
    _assert_trees_equal(_flax(ema_params, port["ema"]["batch_stats"]),
                        {"params": jp["ema"]["params"], "batch_stats": jp["ema"]["batch_stats"]})


# ------------------------------------------------------------- loss, sampler
@pytest.mark.parametrize("weighted", [True, False])
def test_cropped_weighted_ce_matches_jax(weighted):
    import jax.numpy as jnp
    from unetseg_tpu.ops.losses import cropped_weighted_ce as jax_ce
    from unetseg_tpu_torch.ops.losses import cropped_weighted_ce

    rs = np.random.RandomState(5)
    logits = rs.standard_normal((3, 12, 10, 2)).astype(np.float32) * 3
    targets = rs.randint(0, 2, (3, 21, 19)).astype(np.int32)
    weights = (rs.rand(3, 21, 19) * 10).astype(np.float32) if weighted else None
    jl, jt, jw = jax_ce(jnp.asarray(logits), jnp.asarray(targets),
                        None if weights is None else jnp.asarray(weights))
    pl, pt, pw = cropped_weighted_ce(torch.from_numpy(logits), torch.from_numpy(targets),
                                     None if weights is None else torch.from_numpy(weights))
    assert abs(float(pl) - float(jl)) <= 1e-6 * max(1.0, abs(float(jl)))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert pt.shape == (3, 12, 10)
    if weighted:
        np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    else:
        assert pw is None and jw is None


@pytest.mark.parametrize("order,dtype", [(0, np.int32), (0, np.float32), (1, np.float32),
                                         (1, np.uint16)])
def test_sample_2d_matches_jax(order, dtype):
    """Coordinates far outside the frame (reflect), on half-pixel ties
    (nearest rounds half away from zero) and on whole pixels."""
    import jax.numpy as jnp
    from unetseg_tpu.ops.elastic import sample_2d as jax_sample
    from unetseg_tpu_torch.ops.elastic import sample_2d

    rs = np.random.RandomState(11)
    img = (rs.rand(37, 41) * 1000).astype(dtype)
    yy = (rs.rand(48, 52) * 240 - 100).astype(np.float32)
    xx = (rs.rand(48, 52) * 240 - 100).astype(np.float32)
    yy[0, :20], xx[1, :20] = np.arange(20) - 9.5, np.arange(20) - 4.5
    yy[2], xx[2] = np.arange(52) % 37, np.arange(52) % 41
    want = np.asarray(jax_sample(jnp.asarray(img), jnp.asarray(yy), jnp.asarray(xx), order))
    got = sample_2d(torch.from_numpy(img.astype(np.int32) if dtype == np.uint16 else img),
                    torch.from_numpy(yy), torch.from_numpy(xx), order).numpy()
    if order == 0:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype == np.float32 == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    with pytest.raises(NotImplementedError):
        sample_2d(torch.from_numpy(yy), torch.from_numpy(yy), torch.from_numpy(xx), 3)


def test_host_put_tree_matches_jax():
    import jax
    from unetseg_tpu.core.distributed import host_put_tree as jax_put
    from unetseg_tpu_torch.core.distributed import host_put_tree

    rs = np.random.RandomState(2)
    tree = {"a": rs.rand(3, 4).astype(np.float32), "b": [np.arange(5, dtype=np.int32),
                                                          np.float32(2.5)],
            "c": {"d": torch.ones(2, dtype=torch.bfloat16)}}
    got = host_put_tree(tree, "cpu")
    assert isinstance(got["b"], list) and got["c"]["d"].dtype == torch.bfloat16
    want = jax_put({"a": tree["a"], "b": tree["b"]},
                   jax.sharding.SingleDeviceSharding(jax.devices()[0]))
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))
    assert float(got["b"][1]) == float(want["b"][1]) == 2.5
