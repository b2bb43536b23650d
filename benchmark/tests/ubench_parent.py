"""Numbers the four cells compute without a clock, recorded on the CPU
from the harness as it stood before architecture modules (commit
f70f2fe, where flops and synth took the configuration's `model` alone),
and held by test_ubench_sameness.py, test_ubench_flops.py and
test_ubench_reference.py. Recorded by running this file inside an
unpacked copy of that commit:

    d=$(mktemp -d) && git archive f70f2fe BENCHMARK.json benchmark | tar -x -C "$d" &&
    cp benchmark/tests/ubench_parent.py "$d/benchmark/tests/" &&
    (cd "$d" && python3 benchmark/tests/ubench_parent.py)
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path
from typing import Any, Dict

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = ("unet-r15-c2", "unet-r15-c3")
SERVE = ("serve-700x16", "serve-flagship")
SEED = 2**31 + 977  # the base-4 net's logits: test_ubench_reference.py


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def summary(call: Dict[str, Any]) -> Dict[str, Any]:
    """model_flops, bound_s, and a digest of the ordered layers: each one's
    name, operations, bytes, peak and bound."""
    keys = ("name", "ops", "in_bytes", "w_bytes", "out_bytes", "bytes", "peak", "conv", "bound_s")
    return {"model_flops": call["model_flops"], "bound_s": call["bound_s"],
            "layers": sha(json.dumps([[x[k] for k in keys] for x in call["layers"]]).encode())}


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def digests(tree) -> Dict[str, str]:
    """Digests of a variables tree: its leaf paths and shapes, and its values."""
    items = list(leaves(tree))
    return {"leaves": sha(json.dumps([[p, list(v.shape)] for p, v in items]).encode()),
            "values": sha(b"".join(p.encode() + v.tobytes() for p, v in items))}


RECORDED: Dict[str, Any] = {
    "unet-r15-c2/serve-700x16": {
        "model_flops": 7892304601088.0,
        "bound_s": 0.008704079176960656,
        "layers": "93b86366ee5ee06923300d75004373e66fb5416ebd0f6d5e56594a66a7c0ff51",
    },
    "unet-r15-c2/serve-flagship": {
        "model_flops": 85962431594496.0,
        "bound_s": 0.09517424285855913,
        "layers": "ecf6d0171a406e50104b19dd1dc5cebd12c47f6ef836372a0a9ab21d0885cce3",
    },
    "unet-r15-c2/train-recipe": {
        "model_flops": 2685127446528.0,
        "bound_s": 0.0043887311139269875,
        "layers": "44395382715fc61eb42e4e2b134c47842ca22ff5b5eaed9ee593430d58f470a0",
    },
    "unet-r15-c2/param_count": {
        "params": 31042434,
        "stats": 11776,
    },
    "unet-r15-c2/variables": {
        "leaves": "fb77df7ab19d86b064af5de768f22a879a4233795ce12765c5fb598acbcc04d6",
        "values": "a3dca3c0ae1d20872fd4abcd7303ab6dc652668c07525417f31eefb6b5c8aacc",
    },
    "unet-r15-c2/planted":
        "ddc922f184af37254b9476a1496d97df543705f5daaa11e14c710fd04f7ae1b1",
    "unet-r15-c3/train-recipe": {
        "model_flops": 2685288689664.0,
        "bound_s": 0.00439123885959863,
        "layers": "16469006f985e3deb39654112fb2ec0f8ced88ac1f4ab650e1103c50233678bb",
    },
    "unet-r15-c3/param_count": {
        "params": 31042499,
        "stats": 11776,
    },
    "unet-r15-c3/variables": {
        "leaves": "b215018733e0e12d14577b6bea75dce67f4e031912f6ffda4820843a07cbf0f8",
        "values": "9697a49225c6237a1320cb67a85954fbcadd98d0d5c8846f10e5b2b85d3d13d8",
    },
    "logits":
        "07fdc3049ef0003d03e5afac4626c3026bfe50050782a201134e5e713e172ee3",
}


def record() -> Dict[str, Any]:
    """The numbers, by the parent's signatures."""
    sys.path[:0] = [str(BENCH)]
    import torch

    import flops
    import synth
    from reference.unet import forward, to_tensors

    def read(path):
        with open(BENCH / path) as f:
            return json.load(f)

    models = {c: read(f"configs/{c}.json")["model"] for c in CONFIGS}
    out: Dict[str, Any] = {}
    for t in SERVE:
        out[f"{CONFIGS[0]}/{t}"] = summary(flops.serve_call(models[CONFIGS[0]],
                                                            read(f"traffic/{t}.json")))
    plant = read("traffic/serve-700x16.json")["plant"]
    for c, model in models.items():
        out[f"{c}/train-recipe"] = summary(flops.train_step(model,
                                                            read("traffic/train-recipe.json")))
        out[f"{c}/param_count"] = flops.param_count(model)
        v = synth.variables(model, 0, "cpu")
        out[f"{c}/variables"] = digests(v)
        if model["num_classes"] == 2:  # the plant writes a two-class head
            out[f"{c}/planted"] = digests(synth.plant_intensity_path(v, **plant))["values"]
    model = {"in_channels": 1, "num_classes": 3, "base_features": 4, "levels": 5}
    params, stats = to_tensors(synth.variables(model, SEED, "cpu"), "cpu")
    x = torch.rand((2, 188, 188), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _ = forward(params, stats, x[:, None], 5)
    out["logits"] = sha(logits.numpy().tobytes())
    return out


if __name__ == "__main__":
    print(json.dumps(record(), indent=1))
