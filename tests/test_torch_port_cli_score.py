"""The port's `track`, `evaluate`, `evaluate-divisions`, `evaluate-ctc`,
`rescue-labels` and `pipeline` commands on the CPU: the same printed JSON
and files as the JAX commands on the same inputs (chip_smoke's synthetic
CTC sequence written as a data root); `evaluate --torch-checkpoint` on a
synthesized reference-layout .pth against the JAX command; `pipeline
--cpu` end to end, its summary against the port's own `track` and
`evaluate-ctc` on its outputs; and, without --cpu, the device stages
asking for the card."""

import contextlib
import io
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import cell_frames, ctc_sequence, plant_intensity_path, write_ctc_root
from unetseg_tpu.cli.main import main as jax_main
from unetseg_tpu_torch.cli import main as cli
from unetseg_tpu_torch.core.config import ModelConfig
from unetseg_tpu_torch.infer import engine
from unetseg_tpu_torch.metrics import ctc
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.ops import weight_maps
from unetseg_tpu_torch.train import loop
from unetseg_tpu_torch.utils.torch_import import to_reference_state_dict

FRAMES, SIZE = 8, 252


def _run(main, argv):
    """(rc, printed lines) of a command run in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The synthetic sequence as a CTC data root, and instance masks
    m{T}.tif as a segmenter might write them: labels permuted per frame,
    one cell missing from frame 3, one cell in two halves in frame 4."""
    tmp = tmp_path_factory.mktemp("score")
    frames, labels, rows = ctc_sequence(np.random.RandomState(7), FRAMES, SIZE)
    root = str(tmp / "data")
    write_ctc_root(root, frames, labels, rows)
    inst = tmp / "01_RES_INST"
    inst.mkdir()
    rs = np.random.RandomState(1)
    for t, lab in enumerate(labels):
        lab = lab.copy()
        if t == 3:
            lab[lab == 5] = 0
        if t == 4:
            ys, _ = np.nonzero(lab == 6)
            lab[(lab == 6) & (np.arange(SIZE)[:, None] > np.median(ys) + 1)] = 200
        ids = np.unique(lab[lab > 0])
        perm = np.zeros(int(lab.max()) + 1, np.uint16)
        perm[ids] = rs.permutation(len(ids)) + 1
        Image.fromarray(perm[lab]).save(inst / f"m{t:03d}.tif")
    return dict(root=root, inst=str(inst), tmp=tmp)


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            _same_tree(pa, pb)
        elif name.endswith(".tif"):
            np.testing.assert_array_equal(np.array(Image.open(pa)), np.array(Image.open(pb)))
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(pa), np.load(pb))
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read()


@pytest.mark.parametrize("flags", [
    [],
    ["--faithful", "--reference-parent"],
    ["--close-gaps", "2", "--gap-iou", "0.3", "--no-division-from-matched",
     "--prune-divisions", "0", "--min-child-frac", "0.1"],
    ["--iou-track", "0.5", "--iou-division", "0.2", "--max-children", "3",
     "--prune-divisions", "5"],
])
def test_track_equals_jax(data, tmp_path, flags):
    out = {}
    for name, main in (("port", cli.main), ("jax", jax_main)):
        d = tmp_path / name
        rc, lines = _run(main, ["track", "--instance-dir", data["inst"], "--output",
                                str(d / "res_track.txt"), "--ctc-dir", str(d / "ctc"), *flags])
        assert rc == 0
        out[name] = [ln.replace(str(d), "<out>") for ln in lines]
    assert out["port"] == out["jax"]
    assert any("tracked 8 frames" in ln for ln in out["port"])
    _same_tree(tmp_path / "port", tmp_path / "jax")  # res_track.txt, ctc/
    assert cli.main(["track", "--cpu", "--instance-dir", str(tmp_path)]) == 1


@pytest.fixture(scope="module")
def ctc_result(data):
    """The JAX track command's CTC result dir over the instance masks."""
    d = str(data["tmp"] / "ctc_result")
    assert jax_main(["track", "--instance-dir", data["inst"], "--ctc-dir", d, "--output",
                     os.path.join(d, "res_track.txt")]) == 0
    return d


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("measure", ["seg", "tra", "det"])
def test_evaluate_ctc_equals_jax(data, ctc_result, measure, backend):
    gt = os.path.join(data["root"], "01_GT", "SEG" if measure == "seg" else "TRA")
    argv = ["evaluate-ctc", measure, "--gt-dir", gt, "--res-dir", ctc_result, "--backend",
            backend]
    (rc, got), (jrc, want) = _run(cli.main, argv), _run(jax_main, argv)
    assert rc == jrc == 0 and json.loads(got[-1]) == json.loads(want[-1])
    assert 0 < json.loads(got[-1])["SEG" if measure == "seg" else "TRA"] < 1


@pytest.mark.parametrize("flags", [[], ["--details", "--frame-tolerance", "0"]])
def test_evaluate_divisions_equals_jax(data, ctc_result, flags):
    argv = ["evaluate-divisions", "--gt-dir", os.path.join(data["root"], "01_GT", "TRA"),
            "--res-dir", ctc_result, *flags]
    (rc, got), (jrc, want) = _run(cli.main, argv), _run(jax_main, argv)
    assert rc == jrc == 0 and json.loads(got[-1]) == json.loads(want[-1])
    assert json.loads(got[-1])["gt_divisions"] == 1


def test_rescue_labels_equals_jax(data, tmp_path):
    root = data["root"]
    # the silver truth misses two cells of frames 0 and 1: their gold markers rescue them
    for t in (0, 1):
        p = os.path.join(root, "01_ST", "SEG", f"man_seg{t:03d}.tif")
        lab = np.array(Image.open(p))
        lab[np.isin(lab, (5, 7))] = 0
        Image.fromarray(lab).save(tmp_path / f"silver{t}.tif")
    overlay = tmp_path / "root"
    for d in ("01", "01_GT", "01_ST/SEG"):
        (overlay / d).parent.mkdir(parents=True, exist_ok=True)
    os.symlink(os.path.join(root, "01"), overlay / "01")
    os.symlink(os.path.join(root, "01_GT"), overlay / "01_GT")
    (overlay / "01_ST" / "SEG").mkdir(parents=True)
    for t in range(FRAMES):
        src = tmp_path / f"silver{t}.tif" if t < 2 else \
            os.path.join(root, "01_ST", "SEG", f"man_seg{t:03d}.tif")
        os.link(src, overlay / "01_ST" / "SEG" / f"man_seg{t:03d}.tif")
    out = {}
    for name, main in (("port", cli.main), ("jax", jax_main)):
        d = str(tmp_path / name)
        rc, lines = _run(main, ["rescue-labels", "--data-root", str(overlay), "--output-root", d,
                                "--rescue-sequences", "01", "--core-radius", "12",
                                "--ignore-radius", "20"])
        assert rc == 0
        out[name] = [ln.replace(d, "<out>") for ln in lines]
    assert out["port"] == out["jax"]
    assert out["port"][0].startswith("seq 01: 4 missing markers rescued in 2/8 frames")
    for sub in ("SEG", "WEIGHT_MAPS"):
        _same_tree(tmp_path / "port" / "01_ST" / sub, tmp_path / "jax" / "01_ST" / sub)


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    """Sequences 01 and 02 of 252^2 cell frames with shifted silver labels, a
    tiny config and a reference-layout .pth of a planted base-4 net (at
    188^2 the net's output is 4 x 4 and every frame's IoU 1.0)."""
    tmp = tmp_path_factory.mktemp("evaluate")
    root = tmp / "data"
    for seq, seed in (("01", 0), ("02", 1)):
        frames, labels = cell_frames(np.random.RandomState(seed), 5, SIZE, labels=True)
        (root / seq).mkdir(parents=True)
        (root / f"{seq}_ST" / "SEG").mkdir(parents=True)
        for t, (f, lab) in enumerate(zip(frames, labels)):
            Image.fromarray(np.round(f * 255).astype(np.uint8)).save(root / seq / f"t{t:03d}.tif")
            # labels 3 px off the cells: the planted net's masks score under 1
            Image.fromarray(np.roll(lab, 3, axis=1).astype(np.uint16)).save(
                root / f"{seq}_ST" / "SEG" / f"man_seg{t:03d}.tif")
    conf = tmp / "tiny.json"
    conf.write_text(json.dumps({"model": {"base_features": 4, "compute_dtype": "float32"},
                                "infer": {"image_size": SIZE, "min_cell_size": 1}}))
    v = plant_intensity_path(fast_random_variables(
        ModelConfig(base_features=4, compute_dtype="float32"), 3))
    pth = str(tmp / "best_unet_model_epoch_3.pth")
    torch.save(to_reference_state_dict(v), pth)
    return dict(root=str(root), config=str(conf), pth=pth)


@pytest.mark.parametrize("flags", [
    ["--rand"],
    ["--sequences", "01", "02", "--pooled", "--val-only", "--val-percent", "0.4", "--seed",
     "3", "--batch-size", "2", "--rand"],
])
def test_evaluate_equals_jax(eval_root, flags):
    argv = ["evaluate", "--config", eval_root["config"], "--data-root", eval_root["root"],
            "--torch-checkpoint", eval_root["pth"], *flags]
    (rc, got), (jrc, want) = _run(cli.main, [*argv, "--cpu"]), _run(jax_main, argv)
    got, want = json.loads(got[-1]), json.loads(want[-1])
    assert rc == jrc == 0 and set(got) == set(want) and got["n_samples"] == want["n_samples"]
    for k in ("mean_iou", "mean_dice", "mean_rand_index"):
        assert abs(got[k] - want[k]) < 1e-6, (k, got[k], want[k])
    assert 0 < got["mean_iou"] < 1


def _fake_predictor(monkeypatch, seen):
    class Fake:
        def probs(self, images):
            return torch.zeros(len(images), 4, 4)

        def predict_sequence(self, *a, **kw):
            return []

    def ctor(name):
        def make(cls, *args, **kw):
            seen.setdefault("predictor", []).append(kw["device"])
            return Fake()
        return classmethod(make)

    for name in ("from_checkpoint", "from_checkpoints", "from_torch_checkpoint"):
        monkeypatch.setattr(engine.Predictor, name, ctor(name))


@pytest.mark.parametrize("cpu", [False, True])
def test_evaluate_runs_on_the_card_by_default(eval_root, monkeypatch, cpu):
    seen = {}
    _fake_predictor(monkeypatch, seen)
    rc, lines = _run(cli.main, ["evaluate", "--config", eval_root["config"], "--data-root",
                                eval_root["root"], "--checkpoint-dir", "ck",
                                *(["--cpu"] if cpu else [])])
    assert rc == 0 and json.loads(lines[-1])["n_samples"] == 5
    assert seen["predictor"] == ["cpu" if cpu else "cuda"]


@pytest.mark.parametrize("cpu", [False, True])
def test_pipeline_hands_cpu_to_the_device_stages_only(data, monkeypatch, tmp_path, cpu):
    """Without --cpu preprocess, train and predict ask for the card; with
    it, for the CPU; the host stage (track) is never handed it."""
    seen = {}
    _fake_predictor(monkeypatch, seen)

    def fake_weight_map(mask, *a, device="cuda", **kw):
        seen.setdefault("preprocess", set()).add(device)
        return np.zeros(np.shape(mask), np.float32)

    def fake_train(cfg, data=None, max_steps=None, device="cuda", **kw):
        seen["train"] = (device, cfg.train.checkpoint_dir, cfg.train.metrics_jsonl)
        return SimpleNamespace(best_val_loss=0.0, best_epoch=0)

    def fake_track(args):
        seen["track"] = args.cpu
        return 0

    monkeypatch.setattr(weight_maps, "weight_map", fake_weight_map)
    monkeypatch.setattr(loop, "train", fake_train)
    monkeypatch.setattr(cli, "cmd_track", fake_track)
    monkeypatch.setattr(ctc, "seg_measure", lambda *a, **kw: SimpleNamespace(value=0.5))
    monkeypatch.setattr(ctc, "tra_measure", lambda *a, **kw: SimpleNamespace(tra=0.25, det=0.75))
    root = str(tmp_path / "data")
    shutil.copytree(data["root"], root)
    out = str(tmp_path / "out")
    rc, lines = _run(cli.main, ["pipeline", "--data-root", root, "--output-dir", out,
                                *(["--cpu"] if cpu else [])])
    want = "cpu" if cpu else "cuda"
    assert rc == 0
    assert seen["preprocess"] == {want} and seen["predictor"] == [want]
    assert seen["train"] == (want, os.path.join(out, "checkpoints"),
                             os.path.join(out, "metrics.jsonl"))
    assert seen["track"] is False
    assert json.loads(lines[-1]) == {"pipeline": {"01": {"SEG": 0.5, "TRA": 0.25, "DET": 0.75}}}


def test_pipeline_cpu_end_to_end(data, tmp_path):
    """pipeline --cpu on a tiny config: its summary equals the port's own
    track and evaluate-ctc commands on its outputs."""
    root = str(tmp_path / "data")
    shutil.copytree(data["root"], root)
    conf = tmp_path / "tiny.json"
    conf.write_text(json.dumps({
        "model": {"base_features": 4, "compute_dtype": "float32"},
        "train": {"num_epochs": 1, "batch_size": 2},
        "infer": {"tile_input": SIZE, "tile_batch": 4, "min_cell_size": 100,
                  "temporal_markers": True, "boundary_grow": 1.0},
    }))
    out = str(tmp_path / "out")
    rc, lines = _run(cli.main, ["pipeline", "--cpu", "--config", str(conf), "--data-root",
                                root, "--output-dir", out])
    assert rc == 0
    with open(os.path.join(out, "summary.json")) as fh:
        summary = json.load(fh)
    assert json.loads(lines[-1]) == {"pipeline": summary}
    row = summary["01"]
    assert set(row) == {"SEG", "TRA", "DET"} and all(0 <= v <= 1 for v in row.values())
    assert sorted(os.listdir(os.path.join(out, "01_RES_INST"))) == \
        [f"m{t:03d}.tif" for t in range(FRAMES)]
    alone = str(tmp_path / "alone")
    assert cli.main(["track", "--instance-dir", os.path.join(out, "01_RES_INST"), "--ctc-dir",
                     alone, "--output", os.path.join(alone, "res_track.txt")]) == 0
    _same_tree(os.path.join(out, "01_CTC"), alone)
    scores = {}
    for measure, sub in (("seg", "SEG"), ("tra", "TRA")):
        rc, got = _run(cli.main, ["evaluate-ctc", measure, "--gt-dir",
                                  os.path.join(root, "01_GT", sub), "--res-dir", alone])
        scores.update(json.loads(got[-1]))
    assert {k: scores[k] for k in row} == row
