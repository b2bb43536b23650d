from unetseg_tpu_torch._exports import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "unetseg_tpu_torch.post.cc": ("get_instance_masks", "label_components", "remove_small"),
})
