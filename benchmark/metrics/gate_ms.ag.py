"""gate_ms.ag: device milliseconds a masks call of the traced calls' device
operations whose name holds `attn_gate` (the gated net's gate and apply
kernels, csrc/attn_gate.cu), from the trace's breakdown; None unless the
breakdown names both kernels, since it keeps only the top device
operations and a sum of one would read as the pair."""

NAME = "attn_gate"
KERNELS = ("attn_gate_kernel", "attn_gate_apply_kernel")


def read(obs):
    if obs["kind"] != "serve":
        return None
    ops = [(name, s) for name, s in obs["trace"]["breakdown"]["device_ops"] if NAME in name]
    if not all(any(k in name for name, _ in ops) for k in KERNELS):
        return None
    return sum(s for _, s in ops) / obs["traced_units"] * 1e3
