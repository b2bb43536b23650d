"""A/B of the wgmma kernels' design choices on the card: the forward conv
(csrc/conv_fwd_wgmma.cu); with --new, its head variant and the tconv
(csrc/tconv2x2_bias.cu); with --dgrad-stem, the input gradient on the
forward's kernels (csrc/conv3x3_dgrad.cu) and the stem's row kernel
(csrc/conv3x3_bias_relu.cu); with --tail, the fused decoder tail
(dec_tail_kernel of csrc/conv_fwd_wgmma.cu); with --enc0, the fused enc0
(enc0_fused_kernel of csrc/conv_fwd_wgmma.cu).

Each variant is the sources with a few lines of one file replaced, built
into a library of its own under unetseg_tpu_torch/build/variants/ and run
in a process of its own: parity with the plain version at small edge-case
shapes (a variant that skips work reports its error and is not held to
it), then the kernel's torch.profiler device time at serving shapes (16
tiles of 700^2) from 64 to 1024 channels and at the train step's
one-source 64-channel convs (batch 4 at 512^2); with --new instead the
head conv at 16 x 516^2 logits and the tconv at the serving and train
steps' up3; with --dgrad-stem the dgrad at the seven train-step cases
(tier 1's three, tier 2's four) beside the mma.sync dgrad it replaced,
and the stem at the serving (16 x 700^2) and train (4 x 512^2) shapes
beside the FMA kernel it replaced, after edge-case parity (the stem bit
for bit against that kernel); with --tail the tail at the serving shape
(skip 16 x 696^2 read at (88, 88), up 16 x 520^2, 2 classes) beside the
wgmma chain dec_conv0 -> conv3x3_head and the mma.sync tail it replaced,
after edge-case parity (bit for bit against the chain, or the largest
difference); with --enc0 the fused enc0 at the serving shape (16 x 700^2)
beside the chain stem -> wgmma conv1 + pool and the mma.sync kernel it
replaced, after edge-case parity (the same).

    python3 -m unetseg_tpu_torch.ops.kernels.fwd_variants [--new | --dgrad-stem | --tail | --enc0] [variant ...]

Variants: "source" (as it is); "nostore" (the epilogue computes but
stores nothing: what the stores cost); "wst3" (three window stages and
three weight stages at N = 128 instead of two and six); "n64wst3" (N = 64
with three window stages and six weight stages instead of two and
thirteen); "window" (the windowed 8x8 units for every conv, instead of
the im2col form for one source without the pool at N = 128);
"head_streamed" (the head's weight taps through the ring every tile
instead of resident); "tconv_ast2" .. "tconv_ast8" (2, 3, 6 or 8 A stages
instead of four); "tconv_plainst" (the tconv's output stores without the
streaming hint, st.global instead of st.global.cs); "dgrad_window" (the
dgrad's 128- and 256-channel dx through the windowed form at N = 128
instead of the im2col form with its bounding box moved to (-2, -2));
"stem_sw64" (strips of 64 columns instead of 128); "stem_2blk",
"stem_1blk" (two or one block per SM instead of three); "stem_tiles3"
(three output tiles instead of two, a store more in flight; two blocks
then fit an SM); "enc0_nostem" (the fused enc0 without its stem's rows: the
tensor core's work, the stores and the epilogue; wrong bits), "enc0_nomma" (without conv1's wgmmas; wrong bits), "enc0_idle"
(without both), "enc0_nostore" (without its TMA stores), "enc0_noload"
(without its x loads after the first three; wrong bits): what each part
costs. The
default runs source, window, source, window; with --new, source, the four
A depths, tconv_plainst, head_streamed, source; with --dgrad-stem,
source, dgrad_window, stem_sw64, stem_2blk, stem_1blk, stem_tiles3,
source, dgrad_window, stem_2blk; with --tail, source; with --enc0, source,
enc0_nostem, enc0_nomma, enc0_idle, enc0_nostore, enc0_noload, source.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import time
from pathlib import Path

MODULE = "unetseg_tpu_torch.ops.kernels.fwd_variants"
REPO = Path(__file__).resolve().parents[3]
# the fused enc0's conv1 taps, its stem's rows, its stores, and its x loads
# after the first three
ENC0_TAPS = [("      tap_n128(acc, da + tap * (TB_B_STAGE >> 4), db + (tap_offset(tap) >> 4));\n",
              "      ;\n")]
ENC0_STEM = [("        e0_stem_rows<0, E0_SEG>(stl, sw, sb);\n", "")]
ENC0_NOSTORE = [("tma_store_4d_if(storer && oy < Ho,", "tma_store_4d_if(false,"),
                ("tma_store_4d_if(storer && pool_out && oy / 2 < Ho / 2 && ox / 2 < Wo / 2,",
                 "tma_store_4d_if(false,")]
ENC0_NOLOAD = [("      store_x(s);\n      load_x();\n", "")]
PATCHES = {
    "source": [],
    "nostore": [("if (oy < f.Ho && ox < f.Wo)\n", "if (oy < f.Ho && ox < f.Wo && f.relu > 1)\n"),
                ("if (py < f.Ho / 2 && px < f.Wo / 2) {",
                 "if (py < f.Ho / 2 && px < f.Wo / 2 && f.relu > 1) {")],
    "wst3": [("return launch<128, 2, 6>(", "return launch<128, 3, 3>(")],
    "n64wst3": [("return launch<64, 2, 13>(", "return launch<64, 3, 6>(")],
    "window": [("  if (s1.C == 0 && pooled == nullptr && CO % 128 == 0)\n", "  if (false)\n")],
    "head_streamed": [("const bool resident = HEAD && nb == 1 && slices * 9 <= BST;",
                       "const bool resident = false;")],
    "tconv_plainst": [
        ("__stcs(reinterpret_cast<uint4*>(y + (long long)obase[k] * SLICE + shift), v);",
         "*reinterpret_cast<uint4*>(y + (long long)obase[k] * SLICE + shift) = v;")],
    **{f"tconv_ast{n}": [("constexpr int AST = 4, WST = 2;", f"constexpr int AST = {n}, WST = 2;")]
       for n in (2, 3, 6, 8)},
    "dgrad_window": [("  if (s1.C == 0 && pooled == nullptr && CO % 128 == 0)\n",
                      "  if (s1.C == 0 && pooled == nullptr && CO % 128 == 0 && !dgrad)\n")],
    "stem_sw64": [("constexpr int STEM_SW = 128;", "constexpr int STEM_SW = 64;")],
    **{f"stem_{n}blk": [("constexpr int STEM_BLOCKS_PER_SM = 3;",
                         f"constexpr int STEM_BLOCKS_PER_SM = {n};")] for n in (1, 2)},
    "stem_tiles3": [("constexpr int STEM_TILES = 2;", "constexpr int STEM_TILES = 3;")],
    "enc0_nostem": ENC0_STEM,
    "enc0_nomma": ENC0_TAPS,
    "enc0_idle": ENC0_STEM + ENC0_TAPS,
    "enc0_nostore": ENC0_NOSTORE,
    "enc0_noload": ENC0_NOLOAD,
}
# the source file a variant patches, where not conv_fwd_wgmma.cu
SOURCE_OF = {**{k: "tconv2x2_bias.cu" for k in PATCHES if k.startswith("tconv_")},
             **{k: "conv3x3_bias_relu.cu" for k in PATCHES if k.startswith("stem_")}}
DEFAULT = ["source", "window", "source", "window"]
DEFAULT_NEW = ["source", "tconv_ast8", "tconv_ast3", "tconv_ast6", "tconv_ast2", "tconv_plainst",
               "head_streamed", "source"]
DEFAULT_DGRAD_STEM = ["source", "dgrad_window", "stem_sw64", "stem_2blk", "stem_1blk",
                      "stem_tiles3", "source", "dgrad_window", "stem_2blk"]
DEFAULT_TAIL = ["source"]
DEFAULT_ENC0 = ["source", "enc0_nostem", "enc0_nomma", "enc0_idle", "enc0_nostore",
                "enc0_noload", "source"]
MODES = {"--conv": DEFAULT, "--new": DEFAULT_NEW, "--dgrad-stem": DEFAULT_DGRAD_STEM,
         "--tail": DEFAULT_TAIL, "--enc0": DEFAULT_ENC0}


def main(names, mode="--conv"):
    names = names or MODES[mode]
    for name in names:
        if name not in PATCHES:
            raise SystemExit(f"unknown variant {name!r}; variants: {sorted(PATCHES)}")
    for name in names:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", MODULE, mode, name],
                             cwd=REPO, capture_output=True, text=True, timeout=300)
        print(f"variant {name}: rc {res.returncode}, {time.perf_counter() - t0:.1f} s", flush=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(res.stderr[-3000:], flush=True)


def run_variant(name, mode="--conv"):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unetseg_tpu_torch.ops.kernels import build as B

    root = B.BUILD_ROOT / "variants" / f"fwd_{name}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(B.CSRC, root / "csrc")
    src = root / "csrc" / SOURCE_OF.get(name, "conv_fwd_wgmma.cu")
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

    def device(fn, iters=10, kernel="conv_fwd"):
        """fn's device ms per call in the kernels whose names hold `kernel`
        (a name, or a tuple of names)."""
        names = (kernel,) if isinstance(kernel, str) else kernel
        for _ in range(3):  # the profiler can record nothing after many sessions
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and any(k in e.key for k in names)) / 1e3 / iters
            if ms > 0:
                return ms
        raise RuntimeError("torch.profiler recorded no device time in three sessions")

    if mode == "--new":
        return time_new(name, act, weights, worst, device)
    if mode == "--dgrad-stem":
        return time_dgrad_stem(name, act, weights, worst, device)
    if mode == "--tail":
        return time_tail(name, act, weights, device)
    if mode == "--enc0":
        return time_enc0(name, act, weights, device)
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


def time_new(name, act, weights, worst, device):
    """The head conv and the tconv: edge-case parity, then device time at
    the serving path's dec3 conv1 + head (16 x 518^2 x 64 -> 516^2 x 2
    logits) and up3 (16 x 260^2 x 128 -> 520^2 x 64), and the train step's
    up3 (4 x 164^2 x 128)."""
    import torch

    from unetseg_tpu_torch.ops.kernels import conv3x3 as K

    def head_args(b, h, w, nc=2):
        wt, bias = weights(64, 64)
        kh = (torch.randn(nc, 64, 1, 1, device="cuda") * 0.5).to(torch.bfloat16).float()
        return act(b, h, w, 64), wt, bias, kh, 0.1 * torch.randn(nc, device="cuda")

    def tconv_args(b, h, w, ci=128, co=64):
        wt = (torch.randn(ci, co, 2, 2, device="cuda") * (2.0 / (4 * co)) ** 0.5)
        return act(b, h, w, ci), wt.to(torch.bfloat16).float(), 0.1 * torch.randn(co, device="cuda")

    edge = []
    for b, h, w in [(2, 25, 21), (1, 10, 10)]:
        x, wt, bias, kh, bh = head_args(b, h, w)
        a = K.conv3x3_bias_relu_plain(x.float(), wt, bias)
        ref = K.conv3x3_head_plain(x.float(), wt, bias, kh, bh)
        slack = 2.0**-8 * torch.nn.functional.conv2d(a.permute(0, 3, 1, 2).abs(), kh.abs())
        err = (K.conv3x3_head(x, wt, bias, kh, bh) - ref).abs()
        edge.append((err / (1e-2 + 1e-2 * ref.abs() + slack.permute(0, 2, 3, 1))).max().item())
    for b, h, w, ci, co in [(3, 7, 9, 128, 64), (2, 13, 21, 64, 192)]:
        x, wt, bias = tconv_args(b, h, w, ci, co)
        edge.append(worst(K.tconv2x2_bias(x, wt, bias), K.tconv2x2_bias_plain(x.float(), wt, bias)))
    print(f"variant {name}: edge cases worst err/bound {max(edge):.4f}", flush=True)

    args = head_args(16, 518, 518)
    dev = device(lambda: K.conv3x3_head(*args))
    flop = 2 * 16 * 516 * 516 * 64 * (64 * 9 + 2)
    print(f"variant {name} head: device {dev:.4f} ms ({flop / dev / 1e9:.0f} TFLOP/s)", flush=True)
    del args
    for shape, (b, h) in {"up3": (16, 260), "up3_train": (4, 164)}.items():
        x, wt, bias = tconv_args(b, h, h)
        dev = device(lambda: K.tconv2x2_bias(x, wt, bias), kernel="tconv2x2_wgmma")
        n_bytes = b * h * h * 128 * 2 + b * 4 * h * h * 64 * 2
        print(f"variant {name} {shape}: device {dev:.4f} ms ({n_bytes / dev / 1e6:.0f} GB/s)",
              flush=True)
    torch.cuda.empty_cache()


def time_dgrad_stem(name, act, weights, worst, device):
    """The dgrad and the stem: edge-case parity (the dgrad at 64-, 128- and
    256-channel dx from tiny and odd g; the stem bit for bit against the
    FMA kernel it replaced, with the pool on odd sizes and at CO 128),
    then device time of the dgrad at the train step's seven cases and of
    the stem at the serving and train shapes, each beside the kernel it
    replaced on the same tensors."""
    import torch

    from unetseg_tpu_torch.models.shapes import unet_shapes
    from unetseg_tpu_torch.ops.kernels import conv3x3 as K
    from unetseg_tpu_torch.ops.kernels import conv3x3_train as KT

    g = torch.Generator(device="cuda").manual_seed(1)

    def grad(*shape):
        return (torch.rand(*shape, generator=g, device="cuda") - 0.5).to(torch.bfloat16)

    edge, same = [], True
    for b, hg, wg, co, ci in [(1, 1, 1, 64, 64), (4, 2, 3, 64, 128), (1, 2, 3, 128, 256),
                              (4, 13, 9, 64, 128), (1, 37, 21, 128, 256), (2, 17, 30, 128, 64)]:
        gr, (wt, _) = grad(b, hg, wg, co), weights(co, ci)
        edge.append(worst(KT.conv3x3_dgrad(gr, wt), KT.conv3x3_dgrad_plain(gr.float(), wt)))
    for b, h, w, co, pool, relu in [(2, 37, 45, 64, True, True), (3, 9, 7, 64, True, False),
                                    (1, 20, 300, 128, True, True)]:
        x, (wt, bias) = act(b, h, w, 1), weights(co, 1)
        got = K.conv3x3_bias_relu(x, wt, bias, fuse_pool=pool, relu=relu)
        ref = K.stem_fma_reference(x, wt, bias, fuse_pool=pool, relu=relu)
        torch.cuda.synchronize()
        same = same and all(map(torch.equal, got, ref))
    print(f"variant {name}: edge cases worst err/bound {max(edge):.4f}, stem bits equal the FMA "
          f"kernel's: {same}", flush=True)

    sh = unet_shapes(512)
    e0, u, d2 = sh.encoder[0], sh.crops[-1], sh.crops[-2]
    p0 = e0 // 2
    cases = {"enc0_conv1": (e0, 64, 64), "dec3_conv1": (u - 4, 64, 64),
             "dec3_conv0": (u - 2, 64, 128), "dense_enc1_conv0": (p0 - 2, 128, 64),
             "dense_enc1_conv1": (p0 - 4, 128, 128), "dense_dec2_conv0": (d2 - 2, 128, 256),
             "dense_dec2_conv1": (d2 - 4, 128, 128)}
    for case, (n, co, ci) in cases.items():
        gr, (wt, _) = grad(4, n, n, co), weights(co, ci)
        dev = device(lambda: KT.conv3x3_dgrad(gr, wt), kernel="conv_dgrad")
        old = device(lambda: KT.conv3x3_dgrad_mma_reference(gr, wt), kernel="conv3x3_mma_kernel")
        flop = 2 * 4 * n * n * ci * co * 9
        print(f"variant {name} dgrad {case}: device {dev:.4f} ms ({flop / dev / 1e9:.0f} TFLOP/s), "
              f"mma.sync {old:.4f} ms ({old / dev:.2f}x)", flush=True)
    for shape, (b, h, relu) in {"stem_serving": (16, 700, True),
                                "stem_train": (4, 512, False)}.items():
        x, (wt, bias) = act(b, h, h, 1), weights(64, 1)
        dev = device(lambda: K.conv3x3_bias_relu(x, wt, bias, relu=relu), kernel="stem_rows")
        old = device(lambda: K.stem_fma_reference(x, wt, bias, relu=relu), kernel="stem_fma")
        n_bytes = b * h * h * 2 + b * (h - 2) ** 2 * 64 * 2
        print(f"variant {name} {shape}: device {dev:.4f} ms ({n_bytes / dev / 1e6:.0f} GB/s), FMA "
              f"kernel {old:.4f} ms ({old / dev:.2f}x)", flush=True)
        torch.cuda.empty_cache()


def time_tail(name, act, weights, device):
    """The fused decoder tail: edge cases (one band at odd offsets; seven
    bands of 26 steps) against the wgmma chain dec_conv0 -> conv3x3_head,
    bit for bit or the largest difference, then device time at the serving
    shape beside the chain and the mma.sync tail it replaced, on the same
    tensors."""
    import torch

    from unetseg_tpu_torch.ops.kernels import conv3x3 as K

    def tail_args(b, hs, ws, hu, wu, off_y, off_x, nc=2):
        w0, b0 = weights(64, 128)
        w1, b1 = weights(64, 64)
        kh = (torch.randn(nc, 64, 1, 1, device="cuda") * 0.5).to(torch.bfloat16).float()
        return (act(b, hs, ws, 64), act(b, hu, wu, 64), w0, b0, w1, b1, kh,
                0.1 * torch.randn(nc, device="cuda"), off_y, off_x)

    def chain(skip, up, w0, b0, w1, b1, kh, bh, off_y, off_x):
        return K.conv3x3_head(K.dec_conv0(skip, up, w0, b0, off_y, off_x), w1, b1, kh, bh)

    same, diff = True, 0.0
    for shape in [(2, 40, 38, 27, 23, 3, 5), (1, 212, 215, 200, 203, 5, 7)]:
        args = tail_args(*shape)
        got, ref = K.dec_tail(*args), chain(*args)
        torch.cuda.synchronize()
        same = same and torch.equal(got, ref)
        diff = max(diff, ((got - ref).abs().max() / ref.abs().max()).item())
    print(f"variant {name}: edge cases equal the wgmma chain bit for bit: {same} (largest "
          f"difference {diff:.3e} of the largest logit)", flush=True)
    args = tail_args(16, 696, 696, 520, 520, 88, 88)
    dev = device(lambda: K.dec_tail(*args), kernel="dec_tail_kernel")
    chain_dev = device(lambda: chain(*args), kernel="conv_fwd")
    old = device(lambda: K.dec_tail_mma_reference(*args), kernel="dec_tail_mma_kernel")
    flop = 2 * 16 * (518 * 518 * 128 * 64 * 9 + 516 * 516 * 64 * (64 * 9 + 2))
    print(f"variant {name} tail: device {dev:.4f} ms ({flop / dev / 1e9:.0f} TFLOP/s), wgmma "
          f"chain {chain_dev:.4f} ms (tail / chain {dev / chain_dev:.3f}), mma.sync tail "
          f"{old:.4f} ms ({old / dev:.2f}x)", flush=True)
    torch.cuda.empty_cache()


def time_enc0(name, act, weights, device):
    """The fused enc0: edge cases (one band, odd sizes; three bands of 81
    steps; 300 steps, blocks of two or three) against the counted chain
    stem -> wgmma conv1 + pool, bit for bit or the largest difference, then
    device time at the serving shape (16 x 700^2) beside the chain and the
    mma.sync kernel it replaced, on the same tensors."""
    import torch

    from unetseg_tpu_torch.ops.kernels import conv3x3 as K

    def enc0_args(b, h, w):
        w0, b0 = weights(64, 1)
        w1, b1 = weights(64, 64)
        return act(b, h, w, 1), w0, b0, w1, b1

    def chain(x, w0, b0, w1, b1):
        return K.conv3x3_bias_relu(K.conv3x3_bias_relu(x, w0, b0), w1, b1, fuse_pool=True)

    same, diff = True, 0.0
    for shape in [(1, 37, 45), (3, 75, 70), (2, 196, 200)]:
        args = enc0_args(*shape)
        got, ref = K.enc0_fused(*args), chain(*args)
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            same = same and torch.equal(a, r)
            diff = max(diff, ((a.float() - r.float()).abs().max() / r.float().abs().max()).item())
    print(f"variant {name}: edge cases equal the chain bit for bit: {same} (largest difference "
          f"{diff:.3e} of the largest output)", flush=True)
    args = enc0_args(16, 700, 700)
    dev = device(lambda: K.enc0_fused(*args), kernel="enc0_fused_kernel")
    chain_dev = device(lambda: chain(*args), kernel=("stem_rows", "conv_fwd"))
    old = device(lambda: K.enc0_fused_mma_reference(*args), kernel="enc0_fused_mma_kernel")
    flop = 2 * 16 * (698 * 698 * 64 * 9 + 696 * 696 * 64 * 64 * 9)
    print(f"variant {name} enc0: device {dev:.4f} ms ({flop / dev / 1e9:.0f} TFLOP/s), chain "
          f"{chain_dev:.4f} ms (fused / chain {dev / chain_dev:.3f}), mma.sync kernel {old:.4f} "
          f"ms ({old / dev:.2f}x)", flush=True)
    torch.cuda.empty_cache()


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in MODES:
        run_variant(sys.argv[2], mode=sys.argv[1])
    elif sys.argv[1:2] and sys.argv[1] in MODES:
        main(sys.argv[2:], mode=sys.argv[1])
    else:
        main(sys.argv[1:])
