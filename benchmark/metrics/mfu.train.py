"""mfu.train: model FLOPs of the train steps completed in the window (3 x
the forward convs' FLOPs, less the stem's input gradient) over the
window's seconds x the bf16 peak, in %."""

import flops


def read(obs):
    if obs["kind"] != "train":
        return None
    return obs["model_flops"] * obs["units"] / (obs["window_s"] * flops.PEAK_BF16) * 100
