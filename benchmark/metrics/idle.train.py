"""idle.train: the share of the traced train steps' wall time in which no
operation ran on the device: 1 - union of device-busy intervals / wall,
in %."""


def read(obs):
    if obs["kind"] != "train":
        return None
    return (1 - obs["trace"]["busy_s"] / obs["trace"]["wall_s"]) * 100
