"""gate_host_ms.ag: host milliseconds a masks call spends in the program's
serve.gate spans (infer/kernel_net.py: each decoder entry's gate and
apply of the gated net, inside serve.dispatch), over the window's calls,
with the profiler off."""

import program_spans


def read(obs):
    return program_spans.per_unit_ms(obs, "serve", "serve.gate")
