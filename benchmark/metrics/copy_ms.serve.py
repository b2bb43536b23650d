"""copy_ms.serve: device milliseconds of host<->device copies (profiler
Memcpy HtoD and DtoH) per masks call, over the traced calls."""


def read(obs):
    if obs["kind"] != "serve":
        return None
    copies = obs["trace"]["copy_s"]
    return (copies.get("HtoD", 0.0) + copies.get("DtoH", 0.0)) / obs["traced_units"] * 1e3
