"""A/B of csrc/conv_fwd_wgmma.cu's design choices on the card.

Each variant is the source with a few lines replaced, built into a library
of its own under unetseg_tpu_torch/build/variants/ and run in a process of
its own: parity with the plain version at small edge-case shapes (a
variant that skips work reports its error and is not held to it), then the
wgmma kernel's torch.profiler device time at serving shapes (16 tiles of
700^2) from 64 to 1024 channels and at the train step's one-source
64-channel convs (batch 4 at 512^2).

    python3 -m unetseg_tpu_torch.ops.kernels.fwd_variants [variant ...]

Variants: "source" (as it is); "nostore" (the epilogue computes but
stores nothing: what the stores cost); "wst3" (three window stages and
three weight stages at N = 128 instead of two and six); "n64wst3" (N = 64
with three window stages and six weight stages instead of two and
thirteen); "window" (the windowed 8x8 units for every conv, instead of
the im2col form for one source without the pool at N = 128). The default
runs source, window, source, window.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import time
from pathlib import Path

MODULE = "unetseg_tpu_torch.ops.kernels.fwd_variants"
REPO = Path(__file__).resolve().parents[3]
PATCHES = {
    "source": [],
    "nostore": [("if (oy < f.Ho && ox < f.Wo)\n", "if (oy < f.Ho && ox < f.Wo && f.relu > 1)\n"),
                ("if (py < f.Ho / 2 && px < f.Wo / 2) {",
                 "if (py < f.Ho / 2 && px < f.Wo / 2 && f.relu > 1) {")],
    "wst3": [("return launch<128, 2, 6>(", "return launch<128, 3, 3>(")],
    "n64wst3": [("return launch<64, 2, 13>(", "return launch<64, 3, 6>(")],
    "window": [("  if (s1.C == 0 && pooled == nullptr && CO % 128 == 0)\n", "  if (false)\n")],
}
DEFAULT = ["source", "window", "source", "window"]


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

    root = B.BUILD_ROOT / "variants" / f"fwd_{name}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(B.CSRC, root / "csrc")
    src = root / "csrc" / "conv_fwd_wgmma.cu"
    text = src.read_text()
    for old, new in PATCHES[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    src.write_text(text)
    B.CSRC, B.BUILD_ROOT = root / "csrc", root / "lib"
    info = B.build()
    print(f"variant {name}: built in {info['seconds']:.1f} s", flush=True)

    from unetseg_tpu_torch.ops.kernels import conv3x3 as K

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def act(*shape):
        return torch.rand(*shape, generator=g, device="cuda").to(torch.bfloat16)

    def weights(co, ci):
        w = torch.randn(co, ci, 3, 3, generator=g, device="cuda") * (2.0 / (9 * co)) ** 0.5
        return w.to(torch.bfloat16).float(), 0.1 * torch.randn(co, generator=g, device="cuda")

    def worst(got, ref):
        """err / (1e-2 + 1e-2 |ref|), tests/test_torch_port_cuda.py's bound."""
        torch.cuda.synchronize()
        return ((got.float() - ref).abs() / (1e-2 + 1e-2 * ref.abs())).max().item()

    def device(fn, iters=10):
        for _ in range(3):  # the profiler can record nothing after many sessions
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and "conv_fwd" in e.key) / 1e3 / iters
            if ms > 0:
                return ms
        raise RuntimeError("torch.profiler recorded no device time in three sessions")

    edge = []
    for b, h, w, ci, co in [(2, 21, 19, 96, 128), (3, 11, 21, 64, 192), (2, 38, 38, 512, 256)]:
        x, (wt, bias) = act(b, h, w, ci), weights(co, ci)
        edge.append(worst(K.conv3x3_bias_relu(x, wt, bias),
                          K.conv3x3_bias_relu_plain(x.float(), wt, bias)))
    skip, up, (wt, bias) = act(2, 40, 41, 64), act(2, 21, 19, 64), weights(64, 128)
    edge.append(worst(K.dec_conv0(skip, up, wt, bias, 7, 5),
                      K.dec_conv0_plain(skip.float(), up.float(), wt, bias, 7, 5)))
    print(f"variant {name}: edge cases worst err/bound {max(edge):.4f}", flush=True)

    # (batch, output side, ci, co, pool, two sources): serving shapes at 16
    # tiles of 700^2, then the train step's one-source 64-channel convs
    shapes = {"enc0c1_pool": (16, 696, 64, 64, True, False),
              "dec3c0": (16, 518, 128, 64, False, True),
              "enc1c0": (16, 346, 64, 128, False, False),
              "enc1c1_pool": (16, 344, 128, 128, True, False),
              "enc2c1": (16, 168, 256, 256, False, False),
              "enc3c1": (16, 80, 512, 512, False, False),
              "dec0c1": (16, 68, 512, 512, False, False),
              "enc4c0": (16, 38, 512, 1024, False, False),
              "enc4c1": (16, 36, 1024, 1024, False, False),
              "train_enc0c1": (4, 508, 64, 64, False, False),
              "train_dec3c1": (4, 324, 64, 64, False, False)}
    for shape, (bsz, n, ci, co, pool, two) in shapes.items():
        wt, bias = weights(co, ci)
        if two:
            skip, up = act(bsz, 696, 696, ci // 2), act(bsz, n + 2, n + 2, ci // 2)
            kernel = lambda skip=skip, up=up, wt=wt, bias=bias: K.dec_conv0(  # noqa: E731
                skip, up, wt, bias, 88, 88)
        else:
            x = act(bsz, n + 2, n + 2, ci)
            kernel = lambda x=x, wt=wt, bias=bias, pool=pool: K.conv3x3_bias_relu(  # noqa: E731
                x, wt, bias, fuse_pool=pool)
        dev = device(kernel)
        flop = 2 * bsz * n * n * ci * co * 9
        print(f"variant {name} {shape}: device {dev:.4f} ms ({flop / dev / 1e9:.0f} TFLOP/s)",
              flush=True)
        del kernel
        torch.cuda.empty_cache()


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_variant(sys.argv[2])
    else:
        main(sys.argv[1:])
