"""forward_host_ms.train: host milliseconds a train step spends in the
program's train.forward span (train/steps.loss_and_grads: the forward and
the masked mean loss), over the window's steps, with the profiler off."""

import program_spans


def read(obs):
    return program_spans.per_unit_ms(obs, "train", "train.forward")
