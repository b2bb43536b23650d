"""The port's public API against the JAX package's.

Every name a JAX `__init__` exports (read from its source, so this needs
no jax import to list them) resolves in the port's counterpart, apart
from NO_COUNTERPART; `__version__` is equal; importing the port and its
subpackages loads no jax, flax, triton or unetseg_tpu, builds nothing and
turns numpy's hugepage madvise off; `cross_entropy` and `param_count`
equal the JAX functions; and every JAX subcommand's flags are the port's.
"""

from __future__ import annotations

import argparse
import ast
import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unetseg_tpu
from unetseg_tpu.cli.main import build_parser as jax_build_parser
from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models.unet import param_count as jax_param_count
from unetseg_tpu.ops.losses import cross_entropy as jax_cross_entropy
import unetseg_tpu_torch
from unetseg_tpu_torch.cli.main import build_parser
from unetseg_tpu_torch.core.config import ModelConfig
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.models.unet import UNet, create_unet, param_count
from unetseg_tpu_torch.ops.losses import cross_entropy

REPO = Path(__file__).resolve().parents[1]

# (JAX package module, name) -> why the port has no counterpart
NO_COUNTERPART = {
    ("unetseg_tpu.models", "init_unet"):
        "Flax's model.init over a dummy batch; the port's UNet(cfg) holds its parameters from "
        "construction, and seeded variable trees come from models/fast_init",
    ("unetseg_tpu.parallel", "replicate_state"):
        "places a TrainState on every device of a jax mesh; each port rank builds its own "
        "replica from the same seed on its device (create_train_state(device=mesh.device))",
    ("unetseg_tpu.parallel", "make_sharded_tile_forward"):
        "a GSPMD-sharded jit of the tile forward; Predictor(mesh=) shards the tiles over the "
        "ranks (infer/tiling.shard_tile_fn)",
}
# (JAX package module, name) -> why the port's name is the submodule of that
# name, where the JAX package's is a function of it
AS_MODULE = {
    ("unetseg_tpu.ops", "edt"):
        "the JAX re-export of the function edt shadows its own submodule ops/edt.py (the JAX "
        "tests reach the module through importlib); the port keeps ops.edt the submodule, "
        "whose edt is the function",
}
SUBPACKAGES = ("core", "data", "infer", "models", "ops", "parallel", "post", "train", "utils",
               "metrics", "track", "cli", "viz")
# The port's flags that the JAX parser lacks or sets otherwise: (command or
# "*", dest) -> why
CLI_EXCEPTIONS = {
    ("*", "cpu"): "the port's commands run on the card unless --cpu",
    ("export", "platforms"): "the port names cuda,cpu where the JAX command names tpu,cpu",
    ("*", "skip_gates"): "the port's gated net (ModelConfig.skip_gates) has no JAX counterpart",
}
JAX_COMMANDS = ("preprocess", "train", "infer", "predict", "refine", "track", "evaluate",
                "evaluate-divisions", "evaluate-ctc", "visualize", "visualize-prediction",
                "visualize-augmentation", "rescue-labels", "export", "bench", "pipeline")


def exported_names(init: Path):
    """The names an `__init__` binds by `from ... import`."""
    names = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith(
                "unetseg_tpu"):
            names += [a.asname or a.name for a in node.names]
    return names


def module_of(init: Path) -> str:
    return ".".join(init.relative_to(REPO).parent.parts)


# the JAX package's __init__s that export names (cli, viz and ops.pallas export none)
JAX_INITS = [i for i in sorted((REPO / "unetseg_tpu").glob("**/__init__.py"))
             if exported_names(i)]


@pytest.mark.parametrize("init", JAX_INITS, ids=module_of)
def test_every_jax_export_resolves_in_the_port(init):
    jax_mod = module_of(init)
    port = importlib.import_module(jax_mod.replace("unetseg_tpu", "unetseg_tpu_torch", 1))
    names = exported_names(init)
    missing = [n for n in names if (jax_mod, n) not in NO_COUNTERPART and not hasattr(port, n)]
    assert not missing, f"{jax_mod} exports {missing}, which {port.__name__} lacks"
    # the table holds only names that are exported there and still absent
    for (mod, name) in NO_COUNTERPART:
        if mod == jax_mod:
            assert name in names and not hasattr(port, name), (mod, name)
    for (mod, name) in AS_MODULE:
        if mod == jax_mod:
            sub = getattr(port, name)
            assert isinstance(sub, types.ModuleType) and callable(getattr(sub, name))


def test_subpackage_imports_no_sibling():
    """The re-exports load their modules on first use, so the exported
    artifact's loader (infer/export.py) imports neither the engine nor
    training (tests/test_torch_port_export.py runs it in a fresh process)."""
    code = ("import sys, unetseg_tpu_torch.infer, unetseg_tpu_torch.train, unetseg_tpu_torch.ops; "
            "print(sorted(m for m in sys.modules if m.startswith('unetseg_tpu_torch.') "
            "and m.count('.') > 1))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "['unetseg_tpu_torch.core.config']"


def test_no_counterpart_table_names_exported_names():
    listed = {(module_of(i), n) for i in JAX_INITS for n in exported_names(i)}
    assert set(NO_COUNTERPART) <= listed
    assert all(NO_COUNTERPART.values())


def test_version_is_the_jax_packages():
    assert unetseg_tpu_torch.__version__ == unetseg_tpu.__version__ == "0.1.0"


# A fresh process: numpy's madvise forced on, os.mkdir and subprocess.Popen
# recorded, then the port and every subpackage (and the benchmark module)
# imported; it reports what was loaded, created and started.
IMPORT_CHILD = """
import json, os, subprocess, sys
import numpy, torch
from numpy._core import _multiarray_umath as mu
mu._set_madvise_hugepage(True)
made, started = [], []
mkdir, popen = os.mkdir, subprocess.Popen.__init__
os.mkdir = lambda p, *a, **k: (made.append(str(p)), mkdir(p, *a, **k))[1]
def rec(self, args, *a, **k):
    started.append(str(args))
    return popen(self, args, *a, **k)
subprocess.Popen.__init__ = rec
import unetseg_tpu_torch
for s in json.loads(sys.argv[1]):
    __import__("unetseg_tpu_torch." + s)
import unetseg_tpu_torch.bench
os.mkdir, subprocess.Popen.__init__ = mkdir, popen
print(json.dumps({
    "loaded": sorted(m for m in ("jax", "flax", "triton", "unetseg_tpu") if m in sys.modules),
    "made": made, "started": started, "madvise_after": mu._set_madvise_hugepage(False),
    "env": os.environ.get("NUMPY_MADVISE_HUGEPAGE"),
}))
"""


@pytest.fixture(scope="module")
def fresh_import():
    env = {k: v for k, v in os.environ.items() if k != "NUMPY_MADVISE_HUGEPAGE"}
    r = subprocess.run([sys.executable, "-c", IMPORT_CHILD, json.dumps(SUBPACKAGES)],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_import_loads_no_jax_or_triton(fresh_import):
    assert fresh_import["loaded"] == []


def test_import_builds_nothing(fresh_import):
    # numpy.testing (imported by scipy) runs lscpu; no compiler may start
    compilers = ("nvcc", "g++", "gcc", "c++", "'cc'")
    assert fresh_import["made"] == []
    assert not [c for c in fresh_import["started"] if any(x in c for x in compilers)]


def test_import_turns_hugepage_madvise_off(fresh_import):
    assert fresh_import["madvise_after"] is False
    assert fresh_import["env"] == "0"


def test_cross_entropy_matches_jax():
    rs = np.random.RandomState(0)
    for c in (2, 3):
        logits = (rs.randn(2, 7, 9, c) * 3).astype(np.float32)
        targets = rs.randint(0, c, (2, 7, 9)).astype(np.int32)
        want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(targets)))
        got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets)))
        assert abs(got - want) <= 1e-6, (c, got, want)
    # bf16 logits are promoted to f32, as in JAX
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    want = float(jax_cross_entropy(jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
                                   jnp.asarray(targets)))
    assert abs(float(cross_entropy(lb, torch.from_numpy(targets))) - want) <= 1e-6


@pytest.mark.parametrize("kw", [dict(base_features=4), dict(base_features=8, bilinear=True),
                                dict(base_features=4, num_classes=3, levels=4), {}],
                         ids=["base4", "base8_bilinear", "base4_3class_4levels", "full"])
def test_param_count_matches_jax(kw):
    variables = fast_random_variables(ModelConfig(**kw), seed=0)
    n = jax_param_count(variables)
    assert param_count(variables) == n
    assert param_count(UNet(ModelConfig(**kw))) == n
    if not kw:
        assert n == param_count(create_unet()) == 31042434  # the 31M full-width net


def test_jax_model_config_defaults_are_the_ports():
    """Every JAX field's default is the port's; the port's own fields
    (core/config.PORT_ONLY) sit at the default that keeps today's net."""
    from unetseg_tpu_torch.core.config import PORT_ONLY

    ours = dict(ModelConfig().__dict__)
    for k, default in PORT_ONLY["model"].items():
        assert ours.pop(k) == default
    assert JaxModelConfig().__dict__ == ours


def subcommands(parser: argparse.ArgumentParser):
    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return sub.choices


def flags(parser: argparse.ArgumentParser, command: str):
    out = {}
    for a in parser._actions:
        if a.dest == "help":
            continue
        t = a.type
        out[a.dest] = dict(flags=tuple(a.option_strings), default=a.default, const=a.const,
                           action=type(a).__name__, choices=a.choices, nargs=a.nargs,
                           type=getattr(t, "__name__", t), required=a.required)
    return out


@pytest.fixture(scope="module")
def parsers():
    return subcommands(jax_build_parser()), subcommands(build_parser())


def test_the_port_has_every_jax_subcommand(parsers):
    jax_cmds, port_cmds = parsers
    assert sorted(jax_cmds) == sorted(JAX_COMMANDS)
    assert sorted(port_cmds) == sorted(JAX_COMMANDS)


@pytest.mark.parametrize("command", JAX_COMMANDS)
def test_subcommand_flags_match_jax(parsers, command):
    jax_flags = flags(parsers[0][command], command)
    port_flags = flags(parsers[1][command], command)
    for dest in sorted(set(jax_flags) | set(port_flags)):
        excepted = ("*", dest) in CLI_EXCEPTIONS or (command, dest) in CLI_EXCEPTIONS
        if dest not in jax_flags:
            assert excepted, f"{command}: the port adds {dest}"
            continue
        assert dest in port_flags, f"{command}: the port lacks {dest}"
        want, got = dict(jax_flags[dest]), dict(port_flags[dest])
        if excepted:
            want.pop("default")
            got.pop("default")
        assert got == want, (command, dest)
