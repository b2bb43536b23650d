"""copy_in_host_ms.serve: host milliseconds a masks call spends in the
program's serve.copy_in span (infer/engine.Predictor.masks_tiled: the f32
view of the frames and their pageable host-to-device copy), over the
window's calls, with the profiler off."""

import program_spans


def read(obs):
    return program_spans.per_unit_ms(obs, "serve", "serve.copy_in")
