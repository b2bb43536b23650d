"""train_step_ms.recipe: the window's seconds over its train steps, in ms:
the end-to-end train_step_ms, read per layer in the cell where the shared
host's speed spreads it wider than any bound it could take (PERF.md)."""


def read(obs):
    if obs["kind"] != "train":
        return None
    return obs["window_s"] / obs["units"] * 1e3
