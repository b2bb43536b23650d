from unetseg_tpu_torch._exports import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "unetseg_tpu_torch.models.unet": ("UNet", "create_unet", "param_count"),
    "unetseg_tpu_torch.models.shapes": ("shapes",),
})
