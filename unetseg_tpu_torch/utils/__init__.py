from unetseg_tpu_torch._exports import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "unetseg_tpu_torch.utils.profiling": ("DeviceTimer", "annotate", "memory_stats",
                                          "reset_span_totals", "span_totals", "trace"),
})
