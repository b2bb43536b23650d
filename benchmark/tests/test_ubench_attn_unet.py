"""The Attention U-Net's architecture module (reference/attn_unet.py) and
its cell ag-serve-700x16: a whole run of the harness at the tiny size,
the parameter count at the published widths, the gates' layer counts, the
new readers on a stand-in observation, three gate faults planted in the
program at every gate, and four planted in one gate at a time, each read
`correct` false by the cell's check."""

import contextlib
import time

import pytest
import torch
import torch.nn.functional as F

from ubench_tiny import ROOT, tiny_spec, harness

import flops

CELL = "ag-serve-700x16"
SEED = 2**31 + 4242
MODEL = {"in_channels": 1, "num_classes": 2, "base_features": 64, "levels": 5}


@pytest.fixture(scope="module")
def arch():
    return harness.load_cell(CELL, ROOT)["architecture"]


def test_the_cell_runs_correct_through_the_harness():
    spec = tiny_spec(CELL)
    assert spec["config"]["architecture"] == "attn_unet"
    assert spec["config"]["model"]["skip_gates"] is True
    out = harness.run_cell(spec, SEED, 0.2, False, "cpu", time.perf_counter())
    assert out["correct"] and out["checks"]["mask_mismatch"]["value"] == 0.0, out["checks"]
    assert set(out["metrics"]) == {"seg_mpix_s", "seg_call_p95_ms", "setup_s"}


def test_param_count_at_the_published_widths(arch):
    assert flops.param_count(arch, MODEL) == {"params": 32_087_878, "stats": 11_776}
    unet = harness.architecture_of({})
    gates = flops.param_count(arch, MODEL)["params"] - flops.param_count(unet, MODEL)["params"]
    assert gates == sum(3 * f * f + f + 1 for f in (512, 256, 128, 64)) == 1_045_444


def test_gate_layers_at_the_cells_sizes(arch):
    """At 16 tiles of 700^2: 7.24 GFLOP a tile of gates; the gate reads
    each crop and g once (0.48 ms bound), the apply reads and writes the
    crops (0.64 ms); the call's bound is the U-Net's plus the gates'."""
    layers = arch.gate_layers(MODEL, 16, 700)
    gate_ops = sum(v[0]["ops"] for v in layers.values())
    assert abs(gate_ops / 16 / 1e9 - 7.24) < 0.01
    crops = sum(16 * (2 * h) ** 2 * f * 2 for h, f in ((36, 512), (68, 256), (132, 128), (260, 64)))
    assert sum(v[1]["out_bytes"] for v in layers.values()) == crops
    assert abs(sum(v[0]["bound_s"] for v in layers.values()) - 0.48e-3) < 0.01e-3
    assert abs(sum(v[1]["bound_s"] for v in layers.values()) - 0.64e-3) < 0.01e-3
    t = harness.read_json(ROOT / "benchmark/traffic/serve-700x16.json")
    unet = harness.architecture_of({})
    assert flops.serve_call(arch, MODEL, t)["bound_s"] == pytest.approx(
        flops.serve_call(unet, MODEL, t)["bound_s"] + arch.gate_bound_s(MODEL, 16, 700), rel=1e-12)
    names = [x["name"] for x in arch.forward_layers(MODEL, 16, 700)]
    assert names.index("gate3") < names.index("gate3.apply") < names.index("dec3.conv0")


def _stand_in(bound_s, gate_s=(0.006, 0.008), kind="serve"):
    """A traced observation of 10 calls whose breakdown names the gate and
    apply kernels beside two others."""
    ops = [["void conv_fwd_kernel<128>", 0.05],
           ["(anonymous namespace)::attn_gate_kernel(Maps, int)", gate_s[0]],
           ["(anonymous namespace)::attn_gate_apply_kernel(bf16 const*)", gate_s[1]],
           ["Memcpy HtoD (Pageable -> Device)", 0.03]]
    return {"kind": kind, "window_s": 51.0, "units": 2000, "model_flops": 1.0,
            "bound_s": bound_s, "traced_units": 10, "launches": {},
            "trace": {"wall_s": 0.2, "busy_s": 0.18, "kernel_busy_s": 0.15, "copy_s": {},
                      "breakdown": {"device_ops": ops, "idle_gaps": []}}}


def test_new_readers_on_a_stand_in_observation(arch, monkeypatch):
    spec = harness.load_cell(CELL, ROOT)
    call = flops.serve_call(arch, spec["config"]["model"], spec["traffic"])
    obs = _stand_in(call["bound_s"])
    read = {m: harness.metric_reader(m) for m in
            ("roofline.ag", "idle.ag", "gate_ms.ag", "roofline.gate", "gate_host_ms.ag",
             "copy_ms.ag", "mfu.ag", "copy_in_host_ms.ag", "dispatch_host_ms.ag")}
    for m in ("roofline", "copy_ms", "mfu"):
        assert read[f"{m}.ag"](obs) == harness.metric_reader(f"{m}.serve")(obs)
    assert read["idle.ag"](obs) == pytest.approx(10.0)
    assert read["gate_ms.ag"](obs) == pytest.approx(1.4)  # 14 ms over 10 calls
    want = arch.gate_bound_s(MODEL, 16, 700) * 1e3 / 1.4 * 100
    assert read["roofline.gate"](obs) == pytest.approx(want) and 75 < want < 85
    # nothing to read: no gate kernel in the breakdown, or only one of the
    # two (the other cut from the top operations), another cell's call,
    # another kind of cell
    ops = _stand_in(call["bound_s"])["trace"]["breakdown"]["device_ops"]
    for kept in (ops[::3], ops[:2] + ops[3:], ops[:1] + ops[2:]):
        none = _stand_in(call["bound_s"])
        none["trace"]["breakdown"]["device_ops"] = kept
        assert read["gate_ms.ag"](none) is None and read["roofline.gate"](none) is None
    assert read["roofline.gate"](_stand_in(call["bound_s"] * 1.01)) is None
    assert read["gate_ms.ag"](_stand_in(call["bound_s"], kind="train")) is None
    from unetseg_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "serve.call": {"count": 2000, "total_s": 40.0, "self_s": 1.0},
        "serve.copy_in": {"count": 2000, "total_s": 6.0, "self_s": 6.0},
        "serve.dispatch": {"count": 2000, "total_s": 9.0, "self_s": 8.4},
        "serve.gate": {"count": 8000, "total_s": 0.6, "self_s": 0.6}})
    assert read["gate_host_ms.ag"](obs) == pytest.approx(0.3)
    assert read["copy_in_host_ms.ag"](obs) == pytest.approx(3.0)
    assert read["dispatch_host_ms.ag"](obs) == pytest.approx(4.5)
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "serve.call": {"count": 2000, "total_s": 40.0, "self_s": 1.0}})
    assert read["gate_host_ms.ag"](obs) is None  # a program without the span


def _nearest(a):
    return F.interpolate(a, scale_factor=2, mode="nearest")


FAULTS = {
    "alpha_one": ("attn_gate_plain", lambda orig: lambda skip, g, *a: torch.ones(g.shape[:3])),
    "nearest": ("upsample_alpha", lambda orig: _nearest),
    "uncropped": ("attn_gate_plain",
                  lambda orig: lambda skip, g, wx, wg, bg, psi, bpsi, ro, co:
                  orig(skip, g, wx, wg, bg, psi, bpsi, 0, 0)),
}


LEVEL_FAULTS = ("alpha_one", "k_slice", "nearest", "uncropped")


@contextlib.contextmanager
def level_fault(G, fault, width):
    """Plant `fault` in the gate whose skip has `width` channels, and in no
    other, through the wrappers of ops/kernels/attn_gate.py (the CPU route
    and the card's alike): alpha_one, the gate held at 1; k_slice, the
    GEMM summing one of the patch's four taps of K (wx's other three
    dropped); nearest, alpha resampled nearest in place of bilinear;
    uncropped, the gate reading the skip at (0, 0) in place of its crop."""
    gate, apply = G.attn_gate, G.attn_gate_apply

    def hit(skip):
        return skip.shape[-1] == width

    def faulty_gate(skip, g, wx, wg, bg, psi, bpsi, ro, co):
        if hit(skip) and fault == "alpha_one":
            return torch.ones(g.shape[:3], device=g.device)
        if hit(skip) and fault == "uncropped":
            ro = co = 0
        if hit(skip) and fault == "k_slice":
            wx = wx * torch.tensor([[1.0, 0.0], [0.0, 0.0]], device=wx.device)
        return gate(skip, g, wx, wg, bg, psi, bpsi, ro, co)

    def faulty_apply(skip, alpha, ro, co):
        if not (hit(skip) and fault == "nearest"):
            return apply(skip, alpha, ro, co)
        h, w = alpha.shape[1], alpha.shape[2]
        x = skip[:, ro:ro + 2 * h, co:co + 2 * w]
        a = _nearest(alpha[:, None].float())[:, 0, ..., None]
        return (a * x.float()).to(x.dtype).contiguous()

    # on the card the wrappers count their launch through the module's
    # name, which now holds these
    faulty_gate.launches = faulty_apply.launches = 0
    G.attn_gate, G.attn_gate_apply = faulty_gate, faulty_apply
    try:
        yield
    finally:
        G.attn_gate, G.attn_gate_apply = gate, apply


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_gate_fault_reads_not_correct(fault, monkeypatch):
    """A gate held at 1, alpha resampled nearest in place of bilinear, and
    the gate reading the skip at (0, 0) in place of its centre crop: each
    planted in the program's gate (ops/kernels/attn_gate.py, the route a
    CPU run takes) fails the cell's check at the test's size."""
    from unetseg_tpu_torch.ops.kernels import attn_gate as G

    name, make = FAULTS[fault]
    monkeypatch.setattr(G, name, make(getattr(G, name)))
    out = harness.run_cell(tiny_spec(CELL), SEED, 0.2, False, "cpu", time.perf_counter())
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("gate", range(4), ids=lambda i: f"gate{i}")
@pytest.mark.parametrize("fault", LEVEL_FAULTS)
def test_gate_fault_at_one_level_reads_not_correct(fault, gate):
    """Each fault of level_fault planted in one gate alone, the other three
    sound: the planted path carries every gate's alpha to the head through
    the gates below it, so a fault in an upper gate fails the cell's check
    as one in the last does (PERF.md gives each level's readings at the
    cell's size)."""
    from unetseg_tpu_torch.ops.kernels import attn_gate as G

    spec = tiny_spec(CELL)
    width = spec["config"]["model"]["base_features"] * 8 >> gate
    with level_fault(G, fault, width):
        out = harness.run_cell(spec, SEED, 0.2, False, "cpu", time.perf_counter())
    assert not out["correct"], out["checks"]

