"""augment_host_ms.train: host milliseconds a train step spends in the
program's train.augment span (train/steps.make_train_step: the draws when
the step makes them, elastic, photometric, standardise, noise and the
targets), over the window's steps, with the profiler off."""

import program_spans


def read(obs):
    return program_spans.per_unit_ms(obs, "train", "train.augment")
