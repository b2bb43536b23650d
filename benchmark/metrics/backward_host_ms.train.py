"""backward_host_ms.train: host milliseconds a train step spends in the
program's train.backward span (train/steps.loss_and_grads: autograd.grad,
zero gradients for unused leaves, the all-reduce), over the window's
steps, with the profiler off."""

import program_spans


def read(obs):
    return program_spans.per_unit_ms(obs, "train", "train.backward")
