"""dispatch_host_ms.serve: host milliseconds a masks call spends in the
program's serve.dispatch span (infer/engine.Predictor.masks_tiled: grid
planning, the tiled mask function, and enqueueing its pad, tiles, chunk
forwards, merges, stitch and threshold), over the window's calls, with
the profiler off."""

import program_spans


def read(obs):
    return program_spans.per_unit_ms(obs, "serve", "serve.dispatch")
