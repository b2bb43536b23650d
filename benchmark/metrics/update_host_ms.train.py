"""update_host_ms.train: host milliseconds a train step spends in the
program's train.update span (train/steps.make_train_step: apply_gradients,
Adam and the EMA, and the gradients' global norm), over the window's
steps, with the profiler off."""

import program_spans


def read(obs):
    return program_spans.per_unit_ms(obs, "train", "train.update")
