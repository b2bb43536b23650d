"""A/B of csrc/conv3x3_wgrad.cu's design choices on the card.

Each variant is the source with a few lines replaced, built into a library
of its own under unetseg_tpu_torch/build/variants/ and run in a process of
its own: parity with the plain version at edge-case shapes and at the
train step's seven multi-channel weight gradients (batch 4, 512^2 input),
then per shape the wrapper's time by CUDA events beside cuDNN's
conv2d_weight, and the device time of the wgmma kernel and of the reduce
kernel by torch.profiler.

    python3 -m unetseg_tpu_torch.ops.kernels.wgrad_variants [variant ...]

Variants: "source" (as it is), "rows" (each block walks its tiles along
the rows instead of down the columns), "tile8" (8x16-pixel tiles, five
stages), "copies3" (three column-shifted x windows a stage, so that every
tap's descriptor starts on a 1 KB swizzle atom; five stages). The default
runs source, rows, tile8, copies3, source.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import time
from pathlib import Path

MODULE = "unetseg_tpu_torch.ops.kernels.wgrad_variants"
REPO = Path(__file__).resolve().parents[3]
_WIN = "constexpr int X_BYTES = WIN_H * WIN_W * ROW;     // the 6x18 window: 13824"
_STAGES = ("constexpr int STAGES = 8;", "constexpr int STAGES = 5;")
PATCHES = {
    "source": [],
    "rows": [("tile_origin(t_begin + i, GT_W, GT_H, ntx, nty, b, x0, y0);",
              "tile_origin(t_begin + i, GT_H, GT_W, nty, ntx, b, y0, x0);")],
    "tile8": [("constexpr int GT_H = 4,", "constexpr int GT_H = 8,"), _STAGES],
    "copies3": [
        (_WIN, "constexpr int X_BYTES = 3 * WIN_H * GT_W * ROW;"), _STAGES,
        ("tma_load_4d(gs + G_BYTES, xmap, full, cs, x0 + ox, y0 + oy, b);",
         "for (int kx = 0; kx < 3; ++kx) tma_load_4d(gs + G_BYTES + kx * WIN_H * GT_W * ROW, "
         "xmap, full, cs, x0 + ox + kx, y0 + oy, b);"),
        ("wgmma_192(acc, da, sw128_desc(xs + (r + ky) * WIN_W * ROW, ROW, 8 * ROW));",
         "wgmma_192(acc, da, sw128_desc(xs + (r + ky) * GT_W * ROW, WIN_H * GT_W * ROW, "
         "8 * ROW));"),
        ("C0, WIN_W, WIN_H)", "C0, GT_W, WIN_H)"),
        ("C1, WIN_W, WIN_H)", "C1, GT_W, WIN_H)"),
    ],
}
# the wrapper's mirror of the geometry (conv3x3_train.py)
PYTHON = {"tile8": {"WGRAD_TILE": (8, 16), "WGRAD_STAGES": 5}, "copies3": {"WGRAD_STAGES": 5}}
DEFAULT = ["source", "rows", "tile8", "copies3", "source"]


def main(names):
    for name in names or DEFAULT:
        if name not in PATCHES:
            raise SystemExit(f"unknown variant {name!r}; variants: {sorted(PATCHES)}")
    for name in names or DEFAULT:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", MODULE, "--one", name], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        print(f"variant {name}: rc {res.returncode}, {time.perf_counter() - t0:.1f} s", flush=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(res.stderr[-3000:], flush=True)


def run_variant(name):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unetseg_tpu_torch.ops.kernels import build as B

    root = B.BUILD_ROOT / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(B.CSRC, root / "csrc")
    src = root / "csrc" / "conv3x3_wgrad.cu"
    text = src.read_text()
    for old, new in PATCHES[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    src.write_text(text)
    B.CSRC, B.BUILD_ROOT = root / "csrc", root / "lib"
    info = B.build()
    print(f"variant {name}: built in {info['seconds']:.1f} s", flush=True)

    from unetseg_tpu_torch.ops.kernels import conv3x3_train as KT

    for attr, value in PYTHON.get(name, {}).items():
        setattr(KT, attr, value)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def act(*shape):
        return torch.rand(*shape, generator=g, device="cuda").to(torch.bfloat16)

    def grad(*shape):
        return (torch.rand(*shape, generator=g, device="cuda") - 0.5).to(torch.bfloat16)

    def worst(got, ref):
        """err / (1e-2 max |ref| + 1e-2 |ref|), tests/test_torch_port_cuda.py's bound."""
        torch.cuda.synchronize()
        bound = 1e-2 * ref.abs().max() + 1e-2 * ref.abs()
        return ((got - ref).abs() / bound).max().item()

    def events_ms(fn, iters=20):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def device_split(fn, iters=10):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {"wgmma": 0.0, "reduce": 0.0}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                key = "wgmma" if "wgmma" in e.key else "reduce" if "reduce" in e.key else e.key
                out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3 / iters
        return out

    # edge cases: ragged tiles, a g smaller than a tile, 32/96-channel
    # sources, two sources at odd offsets
    edge = []
    for b, h, w, ci, co in [(1, 12, 40, 32, 128), (2, 25, 21, 96, 128), (1, 5, 5, 64, 64)]:
        x, gr = act(b, h, w, ci), grad(b, h - 2, w - 2, co)
        edge.append(worst(KT.conv3x3_wgrad(x, gr), KT.conv3x3_wgrad_plain(x.float(), gr.float())))
    skip, up, gr = act(2, 45, 47, 128), act(2, 20, 23, 128), grad(2, 18, 21, 128)
    edge.append(worst(KT.conv3x3_dec0_wgrad(skip, up, gr, 5, 7),
                      KT.conv3x3_dec0_wgrad_plain(skip.float(), up.float(), gr.float(), 5, 7)))
    print(f"variant {name}: edge cases worst err/bound {max(edge):.4f}", flush=True)

    # (x or skip, up or None, g, crop offset): the train step at 512^2
    shapes = {
        "enc0_conv1": (act(4, 510, 510, 64), None, grad(4, 508, 508, 64), 0),
        "dec3_conv1": (act(4, 326, 326, 64), None, grad(4, 324, 324, 64), 0),
        "dec3_conv0": (act(4, 508, 508, 64), act(4, 328, 328, 64), grad(4, 326, 326, 64), 90),
        "enc1_conv0": (act(4, 254, 254, 64), None, grad(4, 252, 252, 128), 0),
        "enc1_conv1": (act(4, 252, 252, 128), None, grad(4, 250, 250, 128), 0),
        "dec2_conv1": (act(4, 166, 166, 128), None, grad(4, 164, 164, 128), 0),
        "dec2_conv0": (act(4, 250, 250, 128), act(4, 168, 168, 128), grad(4, 166, 166, 128), 41),
    }
    for shape, (x, up, gr, off) in shapes.items():
        if up is None:
            xc = x
            kernel = lambda x=x, gr=gr: KT.conv3x3_wgrad(x, gr)  # noqa: E731
        else:
            xc = torch.cat([x[:, off:off + up.shape[1], off:off + up.shape[2]], up], -1)
            kernel = lambda x=x, up=up, gr=gr, off=off: KT.conv3x3_dec0_wgrad(  # noqa: E731
                x, up, gr, off, off)
        co, ci = gr.shape[3], xc.shape[3]
        got = kernel()
        err = worst(got, KT.conv3x3_wgrad_plain(xc.float(), gr.float()))
        same = torch.equal(kernel(), got)
        cudnn = lambda xc=xc, gr=gr, co=co, ci=ci: torch.nn.grad.conv2d_weight(  # noqa: E731
            xc.permute(0, 3, 1, 2), (co, ci, 3, 3), gr.permute(0, 3, 1, 2))
        ms, lib_ms = events_ms(kernel), events_ms(cudnn)
        dev = device_split(kernel)
        flop = 2 * gr.shape[0] * gr.shape[1] * gr.shape[2] * ci * co * 9
        print(f"variant {name} {shape}: worst err/bound {err:.4f}, bits repeat {same}; events "
              f"{ms:.4f} ms, cuDNN {lib_ms:.4f} ms; device wgmma {dev['wgmma']:.4f} + reduce "
              f"{dev['reduce']:.4f} ms ({flop / (dev['wgmma'] + dev['reduce']) / 1e9:.0f} "
              f"TFLOP/s)", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_variant(sys.argv[2])
    else:
        main(sys.argv[1:])
