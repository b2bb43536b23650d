"""The port's data parallelism on the CPU: two gloo ranks against the
single-process port and the JAX package's data-parallel steps.

Two worker processes join a process group through a file in tmp_path
(core/distributed.maybe_initialize from the UNETSEG_* variables) once per
module, run every data-parallel check and save their results; each check
below reads them. Meanwhile this process computes the references: the
port's single-process step on the whole batch and, for the forwards, the
JAX package's data-parallel steps on a 2-device data mesh (conftest's
virtual devices; the lanes step with interpret-mode kernels):

- make_lanes_dp_train_step (the kernel train forward, its wrappers on
  their plain versions) against JAX make_lanes_dp_train_step, and
  make_sharded_train_step (the plain forward) against JAX
  make_sharded_train_step, with every item valid and with [T, T, T, F];
- tier 2, the eval step, the augmented step's draws (each rank's rows of
  the global draws), the device-resident epoch feed, and train() (rank-0
  writes, a resumed run against an uninterrupted one, the single-process
  loop) under the mesh, against the single-process port;
- tile-sharded tiled_apply and Predictor.masks_tiled against one rank;
- the train command's --mesh on fail-fast, and launch_local's two workers
  through the train command.

The steps are tests/test_lanes_dp.py's: one step of the default SGD
(learning rate 1e-4, momentum 0.99), its parameters held at 2e-5
absolute + 1e-5 relative, batch statistics at 1e-5, the loss at 1e-6;
grad_norm at 1e-5 relative. The gradients themselves are not held
element by element: splitting the BatchNorm sums over two ranks changes
their last bits, and on some seeded batches that alone moves a few
gradients of this net by up to 4e-3 relative to their scale (measured;
the same split of the sums in one process moves them as much), which a
parameter step of 1e-4 absorbs. Variables are tie-free (BatchNorm shifts
+3, tests/test_torch_port_train_step.py) and the masks are disks, as
there. The augmented step is held at 5e-5 relative on its loss and
grad_norm (as tests/test_torch_port_train_step.py holds the augmented
step), serving at 1e-6 and the loop at 1e-6 on its metrics.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from unetseg_tpu.core.config import MeshConfig as JaxMeshConfig
from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
from unetseg_tpu.core.config import TrainConfig as JaxTrainConfig
from unetseg_tpu.core.mesh import make_mesh as jax_make_mesh
from unetseg_tpu.models.unet import UNet as JaxUNet
from unetseg_tpu.parallel import sharding as jax_sharding
from unetseg_tpu.train.state import TrainState as JaxTrainState
from unetseg_tpu.train.state import make_optimizer as jax_make_optimizer
from unetseg_tpu_torch.core import distributed
from unetseg_tpu_torch.core.config import (
    Config, DataConfig, InferConfig, MeshConfig, ModelConfig, TrainConfig,
)
from unetseg_tpu_torch.core.mesh import make_mesh, single_device_mesh
from unetseg_tpu_torch.data import dataset
from unetseg_tpu_torch.infer.engine import Predictor
from unetseg_tpu_torch.infer.tiling import plan_tiles, tiled_apply
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.train.loop import train
from unetseg_tpu_torch.train.state import create_train_state
from unetseg_tpu_torch.train.steps import (
    draw_augment,
    make_epoch_train_step,
    make_eval_step,
    make_train_step,
)
from unetseg_tpu_torch.utils.flax_bridge import state_dict_to_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(base_features=4, compute_dtype="float32")
CFG = ModelConfig(**TINY)
S, B = 188, 4
RECIPE = dict(elastic_alpha=2000.0, elastic_sigma=20.0, standardize=True,
              aug_gamma=0.35, aug_illum=0.15, aug_noise=0.05)
MASKS = {"full": [True] * 4, "masked": [True, True, True, False]}
WORKER_TIMEOUT = 150

WORKER = textwrap.dedent('''
    import contextlib, io, json, os, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from unetseg_tpu_torch.cli.main import main as cli_main
    from unetseg_tpu_torch.core import distributed as D
    from unetseg_tpu_torch.core.config import (
        Config, DataConfig, InferConfig, MeshConfig, ModelConfig, TrainConfig)
    from unetseg_tpu_torch.core.mesh import make_mesh
    from unetseg_tpu_torch.data.dataset import HeLaArrays
    from unetseg_tpu_torch.infer.engine import Predictor
    from unetseg_tpu_torch.infer.tiling import plan_tiles, tiled_apply
    from unetseg_tpu_torch.parallel.sharding import (
        make_lanes_dp_epoch_step, make_lanes_dp_train_step, make_sharded_eval_step,
        make_sharded_train_step, shard_batch)
    from unetseg_tpu_torch.train.loop import train
    from unetseg_tpu_torch.train.state import create_train_state
    from unetseg_tpu_torch.train.steps import AugmentDraws, draw_augment, make_train_step

    work = sys.argv[2]
    assert D.maybe_initialize(cpu=True)  # the UNETSEG_* variables
    assert D.maybe_initialize(cpu=True)  # idempotent
    rank = D.process_index()
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    cfg = ModelConfig(**inp["tiny"])
    mesh = make_mesh(MeshConfig())
    out = {"rank": rank, "count": D.process_count(), "num_data": mesh.num_data,
           "device": str(mesh.device), "shards": D.process_shard_indices(7).tolist()}
    imgs, masks, wts = inp["images"], inp["masks"], inp["weights"]

    def state(**kw):
        return create_train_state(inp["variables"], cfg, TrainConfig(**kw), device="cpu")

    def result(s, m):
        return {"params": s.params, "stats": s.batch_stats,
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}

    for mk, name in ((make_lanes_dp_train_step, "kernel"), (make_sharded_train_step, "plain")):
        for key, valid in inp["valids"].items():
            step = mk(mesh, cfg, augment=False)
            s, m = step(state(), *shard_batch(mesh, imgs, masks, wts, valid), None)
            out[f"{name}_{key}"] = result(s, m)
    # the same two items (and draws) on both ranks: every global sum is
    # twice a rank's, exactly, so the step must be one process's step on
    # the two items; SGD at learning rate 1 makes the parameters' change
    # the gradient
    pair = (imgs[:2], masks[:2], wts[:2])
    gen = torch.Generator().manual_seed(13)
    d2 = draw_augment(gen, torch.zeros(2, 188, 188), True, inp["recipe"]["aug_gamma"],
                      inp["recipe"]["aug_illum"], inp["recipe"]["aug_noise"])
    doubled = AugmentDraws(**{k: torch.cat([v, v]) for k, v in vars(d2).items()})
    out["doubled"] = {}
    for name, lanes, kw in (("kernel", "on", {}), ("plain", "off", {}),
                            ("tier2", "on", {"tier2": True})):
        for key in ("full", "masked"):
            v2 = np.array([True, key == "full"])
            sgd1 = state(learning_rate=1.0, momentum=0.0)
            dp = make_train_step(cfg, lanes=lanes, mesh=mesh, **inp["recipe"], **kw)
            s2, m2 = dp(sgd1, *(torch.from_numpy(a) for a in (*pair, v2)), draws=doubled)
            if rank == 0:
                one = make_train_step(cfg, lanes=lanes, **inp["recipe"], **kw)
                s1, m1 = one(sgd1, *(torch.from_numpy(a) for a in (*pair, v2)), draws=d2)
                out["doubled"][f"{name}_{key}"] = {
                    "loss": (float(m2["loss"]), float(m1["loss"])),
                    "params": [k for k in s1.params if not torch.equal(s1.params[k],
                                                                         s2.params[k])],
                    "means": [k for k in s1.batch_stats if k.endswith("mean")
                              and not torch.equal(s1.batch_stats[k], s2.batch_stats[k])]}

    valid = inp["valids"]["masked"]
    step = make_lanes_dp_train_step(mesh, cfg, augment=False, tier2=True)
    out["tier2"] = result(*step(state(),
                                *shard_batch(mesh, imgs, masks, wts, valid), None))
    ev = make_sharded_eval_step(mesh, cfg)
    out["eval"] = {k: float(v) for k, v in
                   ev(state(), *shard_batch(mesh, imgs, masks, valid)).items()}

    # the augmented step: draws for the global batch, this rank's rows
    gen = torch.Generator().manual_seed(11)
    draws = draw_augment(gen, torch.zeros(2, 188, 188), True, inp["recipe"]["aug_gamma"],
                         inp["recipe"]["aug_illum"], inp["recipe"]["aug_noise"], batch=4)
    out["draws"] = draws.rows(mesh.batch_rows(4))
    step = make_lanes_dp_train_step(mesh, cfg, **inp["recipe"])
    out["augmented"] = result(*step(state(),
                                    *shard_batch(mesh, imgs, masks, wts, np.ones(4, bool)),
                                    torch.Generator().manual_seed(11)))

    # the device-resident epoch feed: the global schedule, this rank's columns
    epoch = make_lanes_dp_epoch_step(mesh, cfg, augment=False)
    s, ms = epoch(state(), *(torch.from_numpy(a) for a in inp["epoch_data"]),
                  torch.from_numpy(inp["epoch_idx"]), torch.from_numpy(inp["epoch_valid"]))
    out["epoch"] = {"params": s.params, "stats": s.batch_stats, "loss": ms["loss"]}

    # tile-sharded serving: 4 tiles a frame (252 -> 68), chunks of 3 padded to 4
    pred = Predictor(cfg, inp["serve_vars"], InferConfig(tile_input=252, tile_batch=3),
                     "cpu", mesh=mesh)
    frames = inp["frames"]
    out["masks_tiled"] = pred.masks_tiled(frames)
    out["probs_tiled"] = pred.probs_tiled(frames[0])
    with torch.inference_mode():
        out["tiled_apply"] = tiled_apply(pred._probs, torch.from_numpy(frames[1]),
                                         plan_tiles(*frames.shape[1:], 252), tile_batch=3,
                                         mesh=mesh)

    # train(): rank-0 writes, and a resumed run against an uninterrupted one
    data = HeLaArrays(*inp["loop_data"], [])
    base = os.path.join(work, "loop")

    def loop_cfg(name, **kw):
        t = dict(batch_size=4, num_epochs=2, checkpoint_dir=os.path.join(base, name),
                 metrics_jsonl=os.path.join(base, name + ".jsonl"), log_every=100)
        t.update(kw)
        return Config(model=cfg, data=DataConfig(**inp["loop_aug"]), train=TrainConfig(**t))

    own = train(loop_cfg(f"own{rank}", num_epochs=1), data=data, mesh=mesh)
    straight = train(loop_cfg("straight"), data=data, mesh=mesh)
    train(loop_cfg("resumed"), data=data, mesh=mesh, max_steps=3)
    resumed = train(loop_cfg("resumed", resume=True), data=data, mesh=mesh)
    out["loop"] = {"straight": {"params": straight.state.params,
                                "stats": straight.state.batch_stats,
                                "history": straight.history},
                   "resumed": {"params": resumed.state.params, "history": resumed.history},
                   "own_history": own.history}

    # the train command under the group: --mesh on with a batch of 3
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli_main(["train", "--cpu", "--mesh", "on", "--batch-size", "3",
                      "--data-root", os.path.join(work, "none")])
        out["cli"] = "no exit"
    except SystemExit as e:
        out["cli"] = str(e)
    assert D.process_count() == 2  # the command left the caller's group up
    D.shutdown()
    torch.save(out, os.path.join(work, f"out{rank}.pt"))
''')


def live_variables(seed, shift=3.0, cfg=CFG):
    """Seeded variables whose BatchNorm shifts keep nearly every ReLU open,
    so no ReLU or max-pool meets an exact tie (whose gradient XLA and
    torch route to different, equally valid inputs)."""
    v = fast_random_variables(cfg, seed)
    for name, block in v["params"].items():
        if name.startswith(("enc", "dec")):
            for i in range(2):
                block[f"bn{i}"]["bias"] += shift
    return v


def disk_frames(n, seed, size=S):
    """n frames with a few disks each (labels 1..5), noise around 0.3 /
    0.7 intensities, and weights in [1, 3)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    masks = np.zeros((n, size, size), np.int32)
    for i in range(n):
        for lab in range(1, 6):
            cy, cx, r = rs.uniform(20, size - 20, 2).tolist() + [rs.uniform(12, 30)]
            masks[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = lab
    imgs = (0.3 + 0.4 * (masks > 0) + 0.05 * rs.randn(n, size, size)).astype(np.float32)
    weights = rs.uniform(1.0, 3.0, (n, size, size)).astype(np.float32)
    return imgs, masks, weights


def _serve_vars():
    sys.path.insert(0, REPO)
    from chip_smoke import plant_intensity_path

    return plant_intensity_path(fast_random_variables(CFG, 4))


def _cell_frames(n, size, seed):
    from chip_smoke import cell_frames

    return cell_frames(np.random.RandomState(seed), n, size)


def _inputs():
    imgs, masks, wts = disk_frames(B, 0)
    e_imgs, e_masks, e_wts = disk_frames(8, 1)
    rs = np.random.RandomState(2)
    idx = np.stack([rs.permutation(8)[:4], rs.permutation(8)[:4]]).astype(np.int32)
    return {
        "tiny": TINY, "recipe": RECIPE, "variables": live_variables(3),
        "images": imgs, "masks": masks, "weights": wts,
        "valids": {k: np.array(v) for k, v in MASKS.items()},
        "epoch_data": (e_imgs, e_masks, e_wts), "epoch_idx": idx,
        "epoch_valid": np.array([[True] * 4, [True, True, False, False]]),
        "serve_vars": _serve_vars(), "frames": _cell_frames(2, 120, 5),
        "loop_data": disk_frames(10, 6), "loop_aug": dict(aug_gamma=0.2, aug_noise=0.05),
    }


def _start_workers(work):
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    env = dict(os.environ, UNETSEG_COORDINATOR=f"file://{work}/rendezvous",
               UNETSEG_NUM_PROCESSES="2", OMP_NUM_THREADS="2")
    procs = []
    for rank in range(2):
        env["UNETSEG_PROCESS_ID"] = str(rank)
        log = open(os.path.join(work, f"worker{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, script, REPO, work], env=dict(env),
                                       stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, timeout):
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in procs:
            if p.poll() is None:  # a straggler: kill it
                p.kill()
                p.wait()
            log.close()


def _launcher_tree(root):
    """A data root of 8 frames with masks and weight maps for the command."""
    from PIL import Image

    imgs, masks, wts = disk_frames(8, 9)
    for sub in ("01", "01_ST/SEG", "01_ST/WEIGHT_MAPS"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(8):
        Image.fromarray((imgs[i].clip(0, 1) * 255).astype(np.uint8)).save(
            os.path.join(root, "01", f"t{i:03d}.tif"))
        Image.fromarray(masks[i].astype(np.uint16)).save(
            os.path.join(root, "01_ST", "SEG", f"man_seg{i:03d}.tif"))
        np.save(os.path.join(root, "01_ST", "WEIGHT_MAPS", f"weight_map_{i:03d}.npy"), wts[i])


def _start_launcher(work):
    root = os.path.join(work, "hela")
    _launcher_tree(root)
    conf = os.path.join(work, "tiny.json")
    with open(conf, "w") as f:
        json.dump({"model": {"base_features": 4}}, f)
    argv = ["train", "--cpu", "--config", conf, "--dtype", "float32", "--data-root", root,
            "--sequence", "01", "--epochs", "1", "--batch-size", "4", "--no-augment",
            "--checkpoint-dir", os.path.join(work, "ck"),
            "--metrics-jsonl", os.path.join(work, "m.jsonl")]
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from unetseg_tpu_torch.cli.main import launch_local;"
            f"sys.exit(launch_local({argv!r}, 2, timeout_s={WORKER_TIMEOUT - 30}))")
    log = open(os.path.join(work, "launcher.log"), "w")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("UNETSEG_COORDINATOR", None)
    return [(subprocess.Popen([sys.executable, "-c", code, REPO], stdout=log,
                              stderr=subprocess.STDOUT, env=env), log)]


def _jax_state(v):
    model = JaxUNet(cfg=JaxModelConfig(**TINY))
    return JaxTrainState.create(apply_fn=model.apply, params=v["params"],
                                batch_stats=v["batch_stats"],
                                tx=jax_make_optimizer(JaxTrainConfig()))


def _jax_refs(inp):
    """JAX make_lanes_dp_train_step and make_sharded_train_step on a
    2-device data mesh, both masks (one compile each)."""
    mesh = jax_make_mesh(JaxMeshConfig(data_parallel=2), devices=jax.devices()[:2])
    jcfg = JaxModelConfig(**TINY)
    steps = {
        "kernel": jax_sharding.make_lanes_dp_train_step(mesh, jcfg, augment=False,
                                                        donate=False, interpret=True),
        "plain": jax_sharding.make_sharded_train_step(mesh, JaxUNet(cfg=jcfg), augment=False,
                                                      donate=False),
    }
    out = {}
    for name, step in steps.items():
        for key, valid in inp["valids"].items():
            st = jax_sharding.replicate_state(mesh, _jax_state(inp["variables"]))
            b = jax_sharding.shard_batch(mesh, inp["images"], inp["masks"], inp["weights"],
                                         valid)
            s, m = step(st, *b, jax.random.key(1))
            tree = jax.tree.map(np.asarray, {"params": s.params, "batch_stats": s.batch_stats})
            out[f"{name}_{key}"] = {"tree": tree, "loss": float(m["loss"]),
                                    "grad_norm": float(m["grad_norm"])}
    return out


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _single_refs(inp, tmp):
    """The single-process port on the whole batch."""
    out = {}

    def state(**kw):
        return create_train_state(inp["variables"], CFG, TrainConfig(**kw), device="cpu")

    batch = _t(inp["images"], inp["masks"], inp["weights"])
    for name, lanes in (("kernel", "on"), ("plain", "off")):
        for key, valid in inp["valids"].items():
            s, m = make_train_step(CFG, lanes=lanes, augment=False)(
                state(), *batch, *_t(valid))
            out[f"{name}_{key}"] = (s, m)
    masked = _t(inp["valids"]["masked"])
    out["tier2"] = make_train_step(CFG, lanes="on", augment=False, tier2=True)(
        state(), *batch, *masked)
    out["eval"] = make_eval_step(CFG)(state(), batch[0], batch[1], *masked)
    gen = torch.Generator().manual_seed(11)
    out["draws"] = draw_augment(gen, batch[0], True, RECIPE["aug_gamma"], RECIPE["aug_illum"],
                                RECIPE["aug_noise"])
    out["augmented"] = make_train_step(CFG, lanes="on", **RECIPE)(
        state(), *batch, *_t(np.ones(4, bool)), torch.Generator().manual_seed(11))
    out["epoch"] = make_epoch_train_step(CFG, lanes="on", augment=False)(
        state(), *_t(*inp["epoch_data"]), *_t(inp["epoch_idx"], inp["epoch_valid"]))
    pred = Predictor(CFG, inp["serve_vars"], InferConfig(tile_input=252, tile_batch=3), "cpu")
    frames = inp["frames"]
    out["masks_tiled"] = pred.masks_tiled(frames)
    out["probs_tiled"] = pred.probs_tiled(frames[0])
    with torch.inference_mode():
        out["tiled_apply"] = tiled_apply(pred._probs, torch.from_numpy(frames[1]),
                                         plan_tiles(*frames.shape[1:], 252), tile_batch=3)
    cfg = Config(model=CFG, data=DataConfig(**inp["loop_aug"]), train=TrainConfig(
        batch_size=4, num_epochs=2, checkpoint_dir=os.path.join(tmp, "single"), log_every=100))
    out["loop"] = train(cfg, data=dataset.HeLaArrays(*inp["loop_data"], []), device="cpu")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the two ranks and the launcher, computes the references
    meanwhile, then waits (a straggler is killed)."""
    work = str(tmp_path_factory.mktemp("dp"))
    inp = _inputs()
    torch.save(inp, os.path.join(work, "inputs.pt"))
    lwork = str(tmp_path_factory.mktemp("launch"))
    procs = _start_workers(work) + _start_launcher(lwork)
    try:
        jax_refs = _jax_refs(inp)
        single = _single_refs(inp, work)
    finally:
        _wait(procs, WORKER_TIMEOUT)
    logs = {name: open(os.path.join(d, name)).read() for d, name in (
        (work, "worker0.log"), (work, "worker1.log"), (lwork, "launcher.log"))}
    codes = [p.returncode for p, _ in procs]
    assert codes == [0, 0, 0], f"exit codes {codes}: {logs}"
    ranks = [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False) for r in (0, 1)]
    return dict(inp=inp, ranks=ranks, jax=jax_refs, single=single, work=work, lwork=lwork,
                launcher_log=logs["launcher.log"])


def _close(got, want, atol, rtol, what):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=atol,
                                   rtol=rtol, err_msg=f"{what} {k}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _ranks_agree(ranks, key):
    a, b = ranks[0][key], ranks[1][key]
    for part in ("params", "stats"):
        for k, t in a[part].items():
            assert torch.equal(t, b[part][k]), f"{key}: ranks differ at {part} {k}"
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]


def test_the_workers_form_a_two_rank_mesh(runs):
    for r, out in enumerate(runs["ranks"]):
        assert (out["rank"], out["count"], out["num_data"], out["device"]) == (r, 2, 2, "cpu")


@pytest.mark.parametrize("path", ["kernel", "plain"])
@pytest.mark.parametrize("mask", list(MASKS))
def test_dp_step_matches_jax_and_single_process(runs, path, mask):
    """Loss, grad_norm, gradients and batch statistics of the 2-rank step
    against JAX's data-parallel step (kernel: make_lanes_dp_train_step;
    plain: make_sharded_train_step) and the port's single-process step;
    both ranks end bit for bit equal."""
    key = f"{path}_{mask}"
    ranks = runs["ranks"]
    _ranks_agree(ranks, key)
    got = ranks[0][key]
    j = runs["jax"][key]
    s1, m1 = runs["single"][key]
    for want_loss, want_norm in ((j["loss"], j["grad_norm"]),
                                 (float(m1["loss"]), float(m1["grad_norm"]))):
        np.testing.assert_allclose(got["loss"], want_loss, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], want_norm, rtol=1e-5)
    _close(got["params"], s1.params, 2e-5, 1e-5, f"{key} params vs single")
    params = _flat(state_dict_to_flax(got["params"])["params"])
    _close(params, _flat(j["tree"]["params"]), 2e-5, 1e-5, f"{key} params vs jax")
    stats = _flat(state_dict_to_flax(got["stats"])["batch_stats"])
    _close(stats, _flat(j["tree"]["batch_stats"]), 1e-5, 1e-5, f"{key} stats vs jax")
    _close(got["stats"], s1.batch_stats, 1e-5, 1e-5, f"{key} stats vs single")


@pytest.mark.parametrize("path", ["kernel", "plain", "tier2"])
@pytest.mark.parametrize("mask", list(MASKS))
def test_dp_step_on_a_doubled_pair_is_the_pair_step(runs, path, mask):
    """Both ranks hold the same two items and draws (augmented with the
    recipe), so every sum over the ranks is twice one rank's, exactly:
    the 2-rank step (SGD at learning rate 1, so a parameter's change is
    its gradient) equals one process's step on the two items bit for bit
    in the loss, every parameter and every running mean (the running
    variances differ by design: their n / (n - 1) counts four items)."""
    got = runs["ranks"][0]["doubled"][f"{path}_{mask}"]
    assert got["loss"][0] == got["loss"][1]
    assert got["params"] == [] and got["means"] == []


def test_tier2_dp_step_matches_single_process(runs):
    ranks = runs["ranks"]
    _ranks_agree(ranks, "tier2")
    got, (s1, m1) = ranks[0]["tier2"], runs["single"]["tier2"]
    np.testing.assert_allclose(got["loss"], float(m1["loss"]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], float(m1["grad_norm"]), rtol=1e-5)
    _close(got["params"], s1.params, 2e-5, 1e-5, "tier2 params")
    _close(got["stats"], s1.batch_stats, 1e-5, 1e-5, "tier2 stats")


def test_eval_step_under_the_mesh(runs):
    """Summed per-rank losses over the global normaliser, accuracy and IoU
    from the summed counts: the single-process metrics of the batch."""
    want = runs["single"]["eval"]
    for out in runs["ranks"]:
        for k, w in want.items():
            np.testing.assert_allclose(out["eval"][k], float(w), atol=1e-6, rtol=1e-6,
                                       err_msg=k)


def test_augmented_draws_are_the_global_draws_rows(runs):
    """Each rank's draws are its rows of the global batch's (bit for bit),
    so the augmented 2-rank step is the single-process step."""
    want = runs["single"]["draws"]
    for r, out in enumerate(runs["ranks"]):
        for f in dataclasses.fields(want):
            w = getattr(want, f.name)
            assert torch.equal(getattr(out["draws"], f.name), w[2 * r : 2 * r + 2]), f.name
    _ranks_agree(runs["ranks"], "augmented")
    got, (s1, m1) = runs["ranks"][0]["augmented"], runs["single"]["augmented"]
    np.testing.assert_allclose(got["loss"], float(m1["loss"]), rtol=5e-5)
    np.testing.assert_allclose(got["grad_norm"], float(m1["grad_norm"]), rtol=5e-5)


def test_epoch_feed_under_the_mesh(runs):
    """make_lanes_dp_epoch_step over the global (2, 4) schedule (the second
    row half padding) equals the single-process epoch step."""
    s1, m1 = runs["single"]["epoch"]
    for out in runs["ranks"]:
        got = out["epoch"]
        np.testing.assert_allclose(got["loss"].numpy(), m1["loss"].numpy(), atol=1e-6,
                                   rtol=1e-6)
        _close(got["params"], s1.params, 2e-5, 1e-5, "epoch params")
        _close(got["stats"], s1.batch_stats, 1e-5, 1e-5, "epoch stats")


def test_make_mesh_resolves_and_refuses():
    """data_parallel -1 takes the ranks the other axes leave; the JAX
    package's divisibility errors; one rank needs no process group."""
    m = single_device_mesh("cpu")
    assert (m.num_data, m.num_tile, m.num_model, m.data_group, m.tile_group) == (1, 1, 1,
                                                                                  None, None)
    assert m.batch_rows(4) == slice(0, 4)
    with pytest.raises(ValueError, match="4 devices not divisible by tile\\*model = 3"):
        make_mesh(MeshConfig(tile_parallel=3), world_size=4, device="cpu")
    with pytest.raises(ValueError, match="mesh 3x1x1 != 4 devices"):
        make_mesh(MeshConfig(data_parallel=3), world_size=4, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(MeshConfig(), world_size=2, device="cpu")
    m = make_mesh(MeshConfig(data_parallel=-1, model_parallel=1), world_size=1, device="cpu")
    assert m.num_data == 1 and m.model_axis == "model"
    with pytest.raises(ValueError, match="does not divide"):
        dataclasses.replace(m, num_data=2, rank=1).batch_rows(3)
    assert dataclasses.replace(m, num_data=2, rank=1).batch_rows(4) == slice(2, 4)


@pytest.mark.parametrize("dp,tp,mp", [(2, 2, 1), (2, 1, 2), (1, 2, 2), (4, 1, 1)])
def test_mesh_groups_follow_the_jax_device_layout(monkeypatch, dp, tp, mp):
    """Ranks take the JAX mesh's (data, tile, model) layout, rank = (d *
    tile + t) * model + m: a rank's data group holds the ranks that differ
    from it only in d, its tile group those that differ in d and t; a group
    of one rank is None and one of every rank the default group (no
    subgroups are made for either)."""
    from unetseg_tpu_torch.core import mesh as mesh_mod

    made = []
    monkeypatch.setattr(mesh_mod.dist, "new_group", lambda ranks: made.append(ranks) or
                        tuple(ranks))
    world = dp * tp * mp
    per_rank = []
    for rank in range(world):
        made.clear()
        data, tile = mesh_mod._groups(dp, tp, mp, rank)
        d, t, m = rank // (tp * mp), (rank // mp) % tp, rank % mp
        want_data = tuple((i * tp + t) * mp + m for i in range(dp))
        want_tile = tuple((i * tp + j) * mp + m for i in range(dp) for j in range(tp))
        for got, want in ((data, want_data), (tile, want_tile)):
            if len(want) == 1:
                assert got is None
            elif len(want) == world:
                assert got is mesh_mod.dist.group.WORLD
            else:
                assert got == want
        per_rank.append(list(made))
        spec = dataclasses.replace(single_device_mesh("cpu"), num_data=dp, num_tile=tp,
                                   num_model=mp, rank=rank)
        assert (spec.data_index, spec.tile_shard_index) == (d, d * tp + t)
    # every rank makes the same subgroups in the same order, each set once
    assert all(p == per_rank[0] for p in per_rank)
    assert len(per_rank[0]) == len({tuple(g) for g in per_rank[0]})


def test_single_process_needs_no_group(monkeypatch):
    for k in ("UNETSEG_COORDINATOR", "UNETSEG_NUM_PROCESSES", "UNETSEG_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize() is False
    assert distributed.maybe_initialize("localhost:1", num_processes=1) is False
    assert not torch.distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.is_primary()
    distributed.barrier()  # no-op
    np.testing.assert_array_equal(distributed.process_shard_indices(5), np.arange(5))
    got = distributed.host_put(np.arange(8).reshape(4, 2), "cpu", 1, 2)
    assert got.tolist() == [[4, 5], [6, 7]]


def test_process_shard_indices(runs):
    got = [out["shards"] for out in runs["ranks"]]
    assert got == [list(a) for a in np.array_split(np.arange(7), 2)]


def test_only_rank0_writes(runs):
    loop = os.path.join(runs["work"], "loop")
    assert os.path.exists(os.path.join(loop, "own0.jsonl"))
    assert os.path.exists(os.path.join(loop, "own0", "full", "0.json"))
    assert not os.path.exists(os.path.join(loop, "own1.jsonl"))
    assert not os.path.exists(os.path.join(loop, "own1"))
    events = [json.loads(line)["event"] for line in open(os.path.join(loop, "own0.jsonl"))]
    assert events.count("start") == 1 and "checkpoint_full" in events
    h0, h1 = ([{k: h[k] for k in ("train_loss", "val_loss", "val_acc", "val_iou")}
               for h in out["loop"]["own_history"]] for out in runs["ranks"])
    assert h0 == h1  # the replicas report the same metrics


def test_resumed_dp_train_equals_uninterrupted(runs):
    """One epoch on the host feed (max_steps), a resume and one more on the
    device feed give the uninterrupted 2-epoch run's state bit for bit, on
    both ranks; the run itself is the single-process loop's."""
    for out in runs["ranks"]:
        a, b = out["loop"]["straight"], out["loop"]["resumed"]
        for k, t in a["params"].items():
            assert torch.equal(b["params"][k], t), k
        assert b["history"][0]["train_loss"] == a["history"][1]["train_loss"]
    single = runs["single"]["loop"]
    got = runs["ranks"][0]["loop"]["straight"]
    for h, w in zip(got["history"], single.history):
        for k in ("train_loss", "val_loss", "val_acc", "val_iou"):
            np.testing.assert_allclose(h[k], w[k], atol=1e-6, rtol=1e-6, err_msg=k)
    _close(got["params"], single.state.params, 2e-5, 1e-5, "loop params")
    _close(got["stats"], single.state.batch_stats, 1e-5, 1e-5, "loop stats")


@pytest.mark.parametrize("what", ["masks_tiled", "probs_tiled", "tiled_apply"])
def test_tile_sharded_serving_equals_one_rank(runs, what):
    want = runs["single"][what]
    for out in runs["ranks"]:
        got = out[what]
        if what == "masks_tiled":
            assert got.dtype == np.uint8 and 0 < got.mean() < 1
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)


def test_cli_mesh_on_refuses_an_indivisible_batch(runs):
    for out in runs["ranks"]:
        assert out["cli"] == ("error: --mesh on with batch_size 3 not divisible by the 2 "
                              "visible devices; pick a divisible --batch-size")


def test_launcher_runs_the_train_command_on_two_workers(runs):
    """launch_local starts two gloo workers of the train command on
    localhost: both end with the same parameters, and only rank 0 wrote
    the metrics and the checkpoints. The workers share the launcher's
    stdout, so the digests are found in the whole log, wherever another
    rank's output lands beside them."""
    log = runs["launcher_log"]
    digests = re.findall(r"rank (\d+) of 2: parameters sha256 ([0-9a-f]{64})", log)
    metrics = os.path.join(runs["lwork"], "m.jsonl")
    events = ([json.loads(line)["event"] for line in open(metrics)]
              if os.path.exists(metrics) else None)
    why = f"launcher log:\n{log}\nevents: {events}"
    assert sorted(r for r, _ in digests) == ["0", "1"], why
    assert digests[0][1] == digests[1][1], why
    assert events is not None and events.count("start") == 1, why
    assert "checkpoint_full" in events, why
    assert os.path.exists(os.path.join(runs["lwork"], "ck", "full", "0.json")), why


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import unetseg_tpu_torch.core.distributed, unetseg_tpu_torch.core.mesh\n"
            "import unetseg_tpu_torch.parallel.sharding\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'unetseg_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
