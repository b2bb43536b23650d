"""roofline.serve: the masks call's least time by its logical layers
(flops.serve_call: max(ops / peak, bytes / HBM) summed), over the
device-busy time of its kernels (copies left out), in %."""


def read(obs):
    if obs["kind"] != "serve" or obs["trace"]["kernel_busy_s"] <= 0:
        return None
    return obs["bound_s"] * obs["traced_units"] / obs["trace"]["kernel_busy_s"] * 100
