"""The flagship reproduction through the port: tools/reproduce_flagship_torch.sh,
tools/collect_results_torch.py and the SEG record that the port's bench
reads (unetseg_tpu_torch/bench.py seg_record).

The script is checked as text and by bash: its syntax, every
`python -m unetseg_tpu_torch` command parsed by the port's parser with the
script's defaults substituted, no JAX command and no --cpu, and its
refusals (no dataset, no card) ending in a non-zero exit before any
training. The collector's table is held to tools/collect_results.py's on
the same summaries (that tool run without --update-latest reaches no JAX
import), then its record rules: the shipped row on top, seed means that
never replace a headline, the card from device.txt, and the refusals.
"""

from __future__ import annotations

import json
import os
import re
import shlex
import subprocess
import sys
from pathlib import Path

import pytest

from unetseg_tpu_torch import bench
from unetseg_tpu_torch.cli.main import build_parser
from unetseg_tpu_torch.utils.provenance import recipe_hash

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "tools" / "reproduce_flagship_torch.sh"
COLLECT = REPO / "tools" / "collect_results_torch.py"
JAX_COLLECT = REPO / "tools" / "collect_results.py"
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


# ------------------------------------------------------------------ script
def script_defaults(text):
    """{VAR: default} of the script's VAR=${VAR:-default} lines."""
    return dict(re.findall(r"^(\w+)=\$\{\1:-([^}]*)\}$", text, re.M))


def script_commands(text):
    """Every `python -m unetseg_tpu_torch ...` command of the script (its
    comments left out), its continuations joined, cut before a redirection
    or && / ||, with the defaults, ENS and the member loop's $s (0)
    substituted; as argv lists after the module name."""
    values = script_defaults(text)
    values["s"] = "0"
    ens = re.search(r'^ENS="([^"]*)"$', text, re.M).group(1)
    values["ENS"] = re.sub(r"\$(\w+)", lambda m: values[m.group(1)], ens)
    code = "\n".join(ln for ln in text.splitlines() if not ln.lstrip().startswith("#"))
    joined = re.sub(r"\\\n\s*", " ", code)
    out = []
    for m in re.finditer(r"python -m unetseg_tpu_torch (.*)", joined):
        cmd = re.split(r"\s(?:>|&&|\|\|)\s", m.group(1))[0]
        cmd = re.sub(r"\$\{?(\w+)\}?", lambda v: values[v.group(1)], cmd)
        out.append(shlex.split(cmd))
    return out


def test_script_syntax():
    r = subprocess.run(["bash", "-n", str(SCRIPT)], capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr


def test_script_commands_parse_in_the_ports_parser():
    text = SCRIPT.read_text()
    defaults = script_defaults(text)
    assert set(defaults) == {"REF", "DATA", "RUN", "EVAL", "CONFIG", "LATEST"}
    assert defaults["CONFIG"] == "configs/best_recipe.json"
    assert defaults["LATEST"] == "docs/results_torch_latest.json"
    cmds = script_commands(text)
    assert [c[0] for c in cmds] == ["preprocess", "train", "pipeline"]
    parser = build_parser()
    args = [parser.parse_args(c) for c in cmds]
    pre, train, pipe = args
    assert (pre.sequence, pre.mode, pre.data_root) == ("02", "reference", defaults["DATA"])
    assert (train.config, train.sequences, train.seed) == (defaults["CONFIG"], ["01", "02"], 0)
    assert train.checkpoint_dir == defaults["RUN"] + "/f0"
    assert train.metrics_jsonl == defaults["EVAL"] + "/train_f0.jsonl"
    assert pipe.checkpoint_dir == ",".join(f"{defaults['RUN']}/f{s}" for s in range(3))
    assert pipe.skip_preprocess and pipe.skip_train and pipe.sequences == ["01", "02"]
    assert pipe.output_dir == defaults["EVAL"] + "/flagship"
    assert not any(a.cpu for a in args)  # training and eval run on the card


def test_script_names_no_jax_command_and_no_cpu_flag():
    text = SCRIPT.read_text()
    assert "python -m unetseg_tpu " not in text and "unetseg_tpu.cli" not in text
    assert "--cpu" not in text and "JAX_PLATFORMS" not in text
    assert "tools/collect_results_torch.py" in text and "tools/collect_results.py" not in text
    assert "results_latest.json" not in text.replace("results_torch_latest.json", "")
    # the same markers and timeouts as the JAX script
    jax_text = (REPO / "tools" / "reproduce_flagship.sh").read_text()
    for marker in ("02_ST/WEIGHT_MAPS/.done", '$RUN/f$s/.done', "$EVAL/flagship/summary.json",
                   "timeout 3600", "timeout 2400"):
        assert marker in text and marker in jax_text


def fake_tools(tmp_path, smi_rc):
    """A bin directory with an nvidia-smi that prints CARD (or fails) and
    a python that records its arguments and fails."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "nvidia-smi").write_text(f"#!/bin/sh\necho '{CARD}'\nexit {smi_rc}\n")
    (bin_dir / "python").write_text(f"#!/bin/sh\necho \"$@\" >> {tmp_path}/python.log\n"
                                    "exit 3\n")
    for f in bin_dir.iterdir():
        f.chmod(0o755)
    return bin_dir


@pytest.mark.parametrize("case", ["no dataset", "no card", "failed step"])
def test_script_stops_with_a_nonzero_exit(tmp_path, case):
    """No dataset: exit 1 before any command. No card (nvidia-smi fails):
    exit 1 after preprocessing and before any training. A failed step (the
    train command exits 3): exit 1, no .done marker, no eval."""
    data = tmp_path / "data"
    if case != "no dataset":
        (data / "02_ST" / "WEIGHT_MAPS").mkdir(parents=True)
        (data / "02_ST" / "WEIGHT_MAPS" / ".done").touch()
    bin_dir = fake_tools(tmp_path, 1 if case == "no card" else 0)
    env = {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}", "REF": str(tmp_path / "ref"),
           "DATA": str(data), "RUN": str(tmp_path / "run"), "EVAL": str(tmp_path / "eval"),
           "LATEST": str(tmp_path / "latest.json")}
    r = subprocess.run(["bash", str(SCRIPT)], capture_output=True, text=True, env=env,
                       timeout=60)
    assert r.returncode == 1, r.stdout + r.stderr
    ran = (tmp_path / "python.log").read_text() if (tmp_path / "python.log").exists() else ""
    assert not (tmp_path / "latest.json").exists()
    if case == "no dataset":
        assert "no dataset" in r.stdout and ran == ""
    elif case == "no card":
        assert "no card" in r.stdout and ran == ""
    else:
        assert (tmp_path / "eval" / "device.txt").read_text().strip() == CARD
        assert ran.startswith("-m unetseg_tpu_torch train") and ran.count("\n") == 1
        assert "train f0 FAILED" in r.stdout and not (tmp_path / "run" / "f0" / ".done").exists()


# --------------------------------------------------------------- collector
def summary(seed):
    """A synthetic per-sequence summary (rounded so its table is exact)."""
    return {q: {"SEG": round(0.80 + 0.01 * seed + 0.001 * i, 6),
                "TRA": round(0.90 + 0.01 * seed + 0.001 * i, 6),
                "DET": round(0.91 + 0.01 * seed + 0.001 * i, 6)}
            for i, q in enumerate(("01", "02"))}


LAYOUTS = {
    "seeds, ens and flagship": {"s0": summary(0), "s1": summary(1), "s2": summary(2),
                                "ens": summary(3), "flagship": summary(4)},
    "ens only, one seed": {"s0": summary(0), "ens": summary(5)},
    "seeds only": {"s0": summary(0), "s1": summary(1), "s2": summary(2)},
    "a sequence missing": {"s0": summary(0), "s1": {"01": summary(1)["01"]},
                           "flagship": summary(6)},
}


def write_eval(root, rows, device=True):
    root.mkdir(parents=True, exist_ok=True)
    for name, s in rows.items():
        (root / name).mkdir()
        (root / name / "summary.json").write_text(json.dumps(s))
    if device:
        (root / "device.txt").write_text(CARD + "\n")
    return root


def collect(*argv, cwd=REPO):
    return subprocess.run([sys.executable, str(COLLECT), *map(str, argv)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_collector_table_equals_the_jax_tools(tmp_path, layout):
    ev = write_eval(tmp_path / "eval", LAYOUTS[layout])
    port = collect(ev)
    jax = subprocess.run([sys.executable, str(JAX_COLLECT), str(ev)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert port.returncode == 0 == jax.returncode, port.stderr + jax.stderr
    assert port.stdout == jax.stdout
    assert ("seed mean" in port.stdout) == (layout in ("seeds, ens and flagship", "seeds only"))


def test_collector_imports_no_jax(tmp_path):
    ev = write_eval(tmp_path / "eval", LAYOUTS["seeds only"])
    code = ("import runpy, sys\n"
            f"sys.argv = ['collect', {str(ev)!r}, '--latest', {str(tmp_path / 'l.json')!r}]\n"
            f"runpy.run_path({str(COLLECT)!r}, run_name='__main__')\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'unetseg_tpu')))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("layout,shipped", [("seeds, ens and flagship", "flagship"),
                                            ("ens only, one seed", "ens"),
                                            ("a sequence missing", "flagship")])
def test_collector_publishes_the_shipped_row(tmp_path, layout, shipped):
    rows = LAYOUTS[layout]
    ev = write_eval(tmp_path / "eval", rows)
    latest = tmp_path / "docs" / "latest.json"
    r = collect(ev, "--latest", latest, "--run-dirs", f"{tmp_path}/f0,{tmp_path}/f1")
    assert r.returncode == 0, r.stderr
    rec = json.loads(latest.read_text())
    want = rows[shipped]
    assert (rec["seg_seq01"], rec["seg_seq02"]) == (want["01"]["SEG"], want["02"]["SEG"])
    assert (rec["tra_seq01"], rec["tra_seq02"]) == (want["01"]["TRA"], want["02"]["TRA"])
    assert f"'{shipped}' eval row" in rec["source"] and CARD in rec["source"]
    assert rec["device"] == CARD and rec["package"] == "unetseg_tpu_torch"
    assert rec["recipe_hash"] == recipe_hash() != ""
    assert rec["checkpoint_dirs"] == [f"{tmp_path}/f0", f"{tmp_path}/f1"]
    assert ("ensemble" in rec) == ("ens" in rows)
    assert ("single_model_3seed_means" in rec) == (layout == "seeds, ens and flagship")


def test_collector_seed_means_never_replace_a_headline(tmp_path):
    """Seeds alone start a record with their means; a later seeds-only
    collection keeps the headline and its stamp (--ship is the explicit
    way to replace it)."""
    latest = tmp_path / "latest.json"
    first = write_eval(tmp_path / "r1", LAYOUTS["seeds only"])
    assert collect(first, "--latest", latest).returncode == 0
    rec = json.loads(latest.read_text())
    assert rec["seg_seq01"] == round((0.80 + 0.81 + 0.82) / 3, 4)
    assert "SINGLE-MODEL means" in rec["source"]
    rec.update(seg_seq01=0.9, eval_date="2000-01-01", device="an older card")
    latest.write_text(json.dumps(rec))
    second = write_eval(tmp_path / "r2", {"s0": summary(7), "s1": summary(8)})
    assert collect(second, "--latest", latest).returncode == 0
    again = json.loads(latest.read_text())
    assert (again["seg_seq01"], again["eval_date"], again["device"]) == (
        0.9, "2000-01-01", "an older card")
    assert set(again["single_model_3seed_means"]) == {"r1", "r2"}
    third = write_eval(tmp_path / "r3", {"s0": summary(7), "x": summary(9)})
    assert collect(third, "--latest", latest, "--ship", "x").returncode == 0
    assert json.loads(latest.read_text())["seg_seq01"] == summary(9)["01"]["SEG"]


def test_collector_refusals(tmp_path):
    ev = write_eval(tmp_path / "eval", LAYOUTS["ens only, one seed"], device=False)
    latest = tmp_path / "latest.json"
    r = collect(ev, "--latest", latest)
    assert r.returncode != 0 and "no device.txt" in r.stderr and not latest.exists()
    (ev / "device.txt").write_text("\n")
    assert collect(ev, "--latest", latest).returncode != 0 and not latest.exists()
    (ev / "device.txt").write_text(CARD + "\n")
    r = collect(ev, "--latest", latest, "--ship", "flagship")
    assert r.returncode != 0 and "no such eval row" in r.stderr and not latest.exists()
    jax_record = REPO / "docs" / "results_latest.json"
    before = jax_record.read_bytes()
    r = collect(ev, "--latest", "docs/results_latest.json")
    assert r.returncode != 0 and "JAX package's record" in r.stderr
    assert jax_record.read_bytes() == before
    assert collect(tmp_path / "empty_dir_absent").returncode != 0


# ------------------------------------------------------------ bench reader
def test_bench_reads_no_record_as_null(tmp_path):
    rec = bench.seg_record(tmp_path / "absent.json")
    assert rec == {"seg_seq01": None, "seg_seq02": None, "seg_source": bench.SEG_SOURCE,
                   "seg_eval_date": None, "seg_recipe_current": None,
                   "seg_checkpoints_present": None}
    assert "not measured" in bench.SEG_SOURCE
    assert bench.RESULTS_PATH == REPO / "docs" / "results_torch_latest.json"
    assert not bench.RESULTS_PATH.exists()  # no SEG of the port is recorded yet
    line = bench.build_record(100.0, 512, 16, {}, {}, CARD,
                              results_path=tmp_path / "absent.json")
    assert line["seg_seq01"] is None and line["seg_source"] == bench.SEG_SOURCE


def test_bench_reads_the_collectors_record(tmp_path):
    ev = write_eval(tmp_path / "eval", LAYOUTS["seeds, ens and flagship"])
    (tmp_path / "f0").mkdir()
    latest = tmp_path / "latest.json"
    assert collect(ev, "--latest", latest, "--run-dirs", tmp_path / "f0").returncode == 0
    rec = json.loads(latest.read_text())
    got = bench.seg_record(latest)
    flagship = LAYOUTS["seeds, ens and flagship"]["flagship"]
    assert (got["seg_seq01"], got["seg_seq02"]) == (flagship["01"]["SEG"], flagship["02"]["SEG"])
    assert got["seg_source"] == rec["source"] and got["seg_eval_date"] == rec["eval_date"]
    assert got["seg_recipe_current"] is True and got["seg_checkpoints_present"] is True
    line = bench.build_record(100.0, 512, 16, {}, {}, CARD, results_path=latest)
    assert {k: line[k] for k in got} == got
    # a record of another recipe, or of checkpoints since removed
    (tmp_path / "f0").rmdir()
    other = tmp_path / "other.json"
    other.write_text("{}")
    got = bench.seg_record(latest, recipe_path=other)
    assert got["seg_recipe_current"] is False and got["seg_checkpoints_present"] is False
