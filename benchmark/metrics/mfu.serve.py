"""mfu.serve: model FLOPs of the masks calls completed in the window (2 x
multiply-adds of every conv, up-conv and head, x the forwards of a call)
over the window's seconds x the bf16 peak, in %."""

import flops


def read(obs):
    if obs["kind"] != "serve":
        return None
    return obs["model_flops"] * obs["units"] / (obs["window_s"] * flops.PEAK_BF16) * 100
