"""The port's serving export on the CPU: the five custom operators of the
default serving forward (ops/kernels/library.py) under torch.library's
opcheck, and infer/export.py against the JAX package's make_serving_fn,
against its own eager module bit for bit, with a symbolic and a pinned
batch, loaded in a fresh process, and through the `export` command.
Tiny nets (base_features=4, 5 levels, fp32, input 188); variables are
seeded numpy arrays in the Flax layout, handed to both packages through
utils/flax_bridge."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.core.config import InferConfig as JaxInferConfig
from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
from unetseg_tpu.infer.export import make_serving_fn as jax_make_serving_fn
from unetseg_tpu_torch.cli.main import main as cli_main
from unetseg_tpu_torch.core.config import InferConfig, ModelConfig, TrainConfig
from unetseg_tpu_torch.infer.engine import Predictor
from unetseg_tpu_torch.infer.export import (
    export_inference,
    load_exported,
    make_serving_fn,
    save_exported,
)
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.ops.kernels import library
from unetseg_tpu_torch.train.checkpoint import Checkpointer, device_light_payload
from unetseg_tpu_torch.train.state import create_train_state

REPO = str(Path(__file__).resolve().parents[1])
TINY = dict(base_features=4, compute_dtype="float32")
SEED = 2  # a tiny random net whose probabilities spread around 0.5
SIZE = 188  # output 4x4
ATOL = 2e-4  # tests/test_torch_port_slice.py's tolerance against the JAX U-Net
NORMS = {"normalize": dict(normalize=True), "standardize": dict(standardize=True)}
OP_NAMES = {f"unetseg.{name}.default" for name in library.OPS}


def _x(seed, b):
    return np.random.RandomState(seed).rand(b, SIZE, SIZE).astype(np.float32)


def _cfg(classes):
    return ModelConfig(num_classes=classes, **TINY)


@pytest.fixture(scope="module")
def nets():
    return {c: fast_random_variables(_cfg(c), SEED + c) for c in (2, 3)}


@pytest.fixture(scope="module")
def artifacts(nets, tmp_path_factory):
    """One symbolic-batch CPU artifact per (normalisation, head), exported once."""
    d = tmp_path_factory.mktemp("export")
    out = {}
    for norm, kw in NORMS.items():
        for classes in (2, 3):
            path = str(d / f"{norm}{classes}.pt2")
            save_exported(path, export_inference(_cfg(classes), nets[classes],
                                                 InferConfig(image_size=SIZE, **kw),
                                                 platforms=("cpu",), device="cpu"))
            out[norm, classes] = path
    return out


def _ops_of(exported):
    return {str(n.target) for n in exported.graph.nodes if n.op == "call_function"} & OP_NAMES


def _op_args(name, g):
    def r(*shape):
        return torch.randn(*shape, generator=g)

    x, w, b = r(2, 9, 11, 8), r(6, 8, 3, 3), r(6)
    return {
        "conv3x3_bias_relu": [(x, w, b), (x, w, b, False)],
        "conv3x3_bias_relu_pool": [(x, w, b)],
        "tconv2x2_bias": [(x, r(8, 5, 2, 2), r(5))],
        "dec_conv0": [(r(2, 14, 13, 3), r(2, 8, 7, 5), r(4, 8, 3, 3), r(4), 3, 2),
                      (r(2, 14, 13, 3), r(2, 8, 7, 5), r(4, 8, 3, 3), r(4), 1, 0, False)],
        "conv3x3_head": [(x, w, b, r(3, 6, 1, 1), r(3))],
    }[name]


@pytest.mark.parametrize("name", library.OPS)
def test_opcheck(name):
    """Schema, fake (shapes, dtypes, strides) against the plain version,
    and the AOT dispatch of each operator, at tiny shapes."""
    op = getattr(torch.ops.unetseg, name).default
    for args in _op_args(name, torch.Generator().manual_seed(0)):
        res = torch.library.opcheck(op, args)
        assert set(res.values()) == {"SUCCESS"}, res


def test_ops_equal_their_wrappers():
    """Each operator returns its counted wrapper's result (contiguous)."""
    from unetseg_tpu_torch.ops.kernels import conv3x3 as K

    g = torch.Generator().manual_seed(1)
    for name in library.OPS:
        for args in _op_args(name, g):
            got = getattr(torch.ops.unetseg, name)(*args)
            if name.startswith("conv3x3_bias_relu"):  # relu is the op's fourth argument
                want = K.conv3x3_bias_relu(*args[:3], fuse_pool=name.endswith("_pool"),
                                           relu=args[3] if len(args) > 3 else True)
            else:
                want = getattr(K, name)(*args)
            for a, b in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
                assert a.is_contiguous() and torch.equal(a, b.contiguous()), name


@pytest.mark.parametrize("norm", sorted(NORMS))
@pytest.mark.parametrize("classes", [2, 3])
def test_exported_matches_jax_serving_fn(nets, artifacts, norm, classes):
    jcfg = JaxModelConfig(num_classes=classes, **TINY)
    want = np.asarray(jax_make_serving_fn(jcfg, nets[classes],
                                          JaxInferConfig(image_size=SIZE, **NORMS[norm]))(
        jnp.asarray(_x(3, 2))))
    got = load_exported(artifacts[norm, classes])(_x(3, 2)).numpy()
    assert got.shape == want.shape == ((2, 4, 4) if classes == 2 else (2, 4, 4, 3))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_round_trip_bit_for_bit(nets, artifacts):
    """The loaded artifact equals its eager module and Predictor.probs on
    the same frames, bit for bit, through the five operators."""
    icfg = InferConfig(image_size=SIZE, normalize=True)
    fn = load_exported(artifacts["normalize", 2])
    assert fn.platforms == ("cpu",)
    assert _ops_of(fn.exported) == OP_NAMES
    x = _x(4, 3)
    eager = make_serving_fn(_cfg(2), nets[2], icfg, "cpu")
    assert eager.kernels
    with torch.no_grad():
        want = eager(torch.from_numpy(x))
    got = fn(x)
    assert torch.equal(got, want)
    assert torch.equal(got, Predictor(_cfg(2), nets[2], icfg, "cpu").probs(x))


def test_symbolic_batch_serves_any_batch(artifacts):
    fn = load_exported(artifacts["standardize", 2])
    for b in (1, 2, 5):
        p = fn(_x(b, b))
        assert p.shape == (b, 4, 4)
        assert bool(((p >= 0) & (p <= 1)).all())
    p3 = load_exported(artifacts["standardize", 3])(_x(6, 2))
    np.testing.assert_allclose(p3.sum(-1).numpy(), 1.0, atol=1e-6)


def test_pinned_batch_raises_at_another(nets, tmp_path):
    path = str(tmp_path / "pinned.pt2")
    save_exported(path, export_inference(_cfg(2), nets[2], InferConfig(image_size=SIZE),
                                         batch=2, platforms=("cpu",), device="cpu"))
    fn = load_exported(path)
    assert fn(_x(0, 2)).shape == (2, 4, 4)
    with pytest.raises(Exception):
        fn(_x(0, 3))


def test_platforms_choose_the_forward_and_the_load_device(nets, artifacts, tmp_path):
    """A CPU-only artifact refuses the card; an artifact that also names
    the card, of a net the card's kernels do not run (base 4, fp32),
    exports the plain folded net and moves to a named device."""
    with pytest.raises(ValueError, match="exported for cpu, not cuda"):
        load_exported(artifacts["normalize", 2], device="cuda")
    path = str(tmp_path / "both.pt2")
    icfg = InferConfig(image_size=SIZE, normalize=True)
    save_exported(path, export_inference(_cfg(2), nets[2], icfg, device="cpu"))
    fn = load_exported(path, device="cpu")
    assert fn.platforms == ("cuda", "cpu") and not _ops_of(fn.exported)
    assert not make_serving_fn(_cfg(2), nets[2], icfg, "cpu", ("cuda", "cpu")).kernels
    np.testing.assert_allclose(fn(_x(7, 2)).numpy(),
                               Predictor(_cfg(2), nets[2], icfg, "cpu").probs(_x(7, 2)).numpy(),
                               atol=1e-6)
    with pytest.raises(ValueError, match="platforms"):
        export_inference(_cfg(2), nets[2], icfg, platforms=("tpu",), device="cpu")


def test_fresh_process_load_needs_no_engine_nor_training(artifacts, tmp_path):
    x = _x(8, 2)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys, numpy as np, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from unetseg_tpu_torch.infer.export import load_exported\n"
        f"fn = load_exported({artifacts['normalize', 2]!r}, device='cpu')\n"
        f"np.save({str(tmp_path / 'p.npy')!r}, fn(np.load({str(tmp_path / 'x.npy')!r})).numpy())\n"
        "print(sorted(m for m in sys.modules if m in ('unetseg_tpu_torch.infer.engine',"
        " 'unetseg_tpu_torch.train') or m.split('.')[0] in ('jax', 'unetseg_tpu')))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    want = load_exported(artifacts["normalize", 2])(x).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"), want)


def _port_checkpoint(variables, directory):
    state = create_train_state(variables, _cfg(2), TrainConfig(ema_decay=0.5), device="cpu")
    Checkpointer(directory).save_light_payload(device_light_payload(state), 0, 0.25)
    return directory


def _config(tmp_path, **infer):
    path = str(tmp_path / "tiny.json")
    with open(path, "w") as f:
        json.dump({"model": {"base_features": 4}, "infer": {"image_size": SIZE, **infer}}, f)
    return path


def test_export_command_from_a_port_checkpoint(nets, tmp_path, capsys):
    ck = _port_checkpoint(nets[2], str(tmp_path / "ck"))
    out = str(tmp_path / "cmd.pt2")
    assert cli_main(["export", "--cpu", "--config", _config(tmp_path), "--dtype", "float32",
                     "--checkpoint-dir", ck, "--standardize", "--platforms", "cpu",
                     "--output", out]) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    fn = load_exported(out)
    assert _ops_of(fn.exported) == OP_NAMES
    icfg = InferConfig(image_size=SIZE, standardize=True)
    pred = Predictor.from_checkpoint(ck, _cfg(2), icfg, device="cpu")
    for b in (1, 3):
        assert torch.equal(fn(_x(9, b)), pred.probs(_x(9, b)))


def test_export_command_refuses_an_ensemble(nets, tmp_path):
    ck = _port_checkpoint(nets[2], str(tmp_path / "ck"))
    base = ["export", "--cpu", "--dtype", "float32", "--output", str(tmp_path / "e.pt2")]
    for argv in ([*base, "--config", _config(tmp_path), "--checkpoint-dir", f"{ck},{ck}"],
                 [*base, "--config", _config(tmp_path, use_ema="both"),
                  "--checkpoint-dir", ck]):
        with pytest.raises(SystemExit, match="export serves one member"):
            cli_main(argv)
    assert not os.path.exists(tmp_path / "e.pt2")
