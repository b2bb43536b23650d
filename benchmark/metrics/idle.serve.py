"""idle.serve: the share of the traced masks calls' wall time in which no
operation ran on the device: 1 - union of device-busy intervals / wall,
in %."""


def read(obs):
    if obs["kind"] != "serve":
        return None
    return (1 - obs["trace"]["busy_s"] / obs["trace"]["wall_s"]) * 100
