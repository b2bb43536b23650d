"""roofline.gate: the gates' share of their roofline, in %: the least time
of the gate and apply layers of a masks call (the architecture module's
gate_bound_s over the call's forwards, at the cell's tile batch and tile
size) over gate_ms.ag's device time. The cell is the one of this metric's
`workloads` whose whole call's bound is the observation's; None where none
is, or where gate_ms.ag reads nothing."""

import flops
import harness

NAME = "roofline.gate"


def _gate_bound_s(obs):
    bench = harness.benchmark_json(harness.HERE.parent)
    cells = next(m for m in bench["per_layer"] if m["name"] == NAME)["workloads"]
    for name in cells:
        spec = harness.load_cell(name, harness.HERE.parent)
        arch, model, t = spec["architecture"], spec["config"]["model"], spec["traffic"]
        call = flops.serve_call(arch, model, t)
        if abs(call["bound_s"] - obs["bound_s"]) <= 1e-12 * call["bound_s"]:
            return call["forwards"] * arch.gate_bound_s(model, t["tile_batch"], t["tile_input"])
    return None


def read(obs):
    ms = harness.metric_reader("gate_ms.ag")(obs)
    if ms is None or ms <= 0:
        return None
    bound = _gate_bound_s(obs)
    return None if bound is None else bound * 1e3 / ms * 100
