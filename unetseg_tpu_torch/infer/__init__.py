from unetseg_tpu_torch._exports import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "unetseg_tpu_torch.infer.engine": ("Predictor", "load_image_01"),
    "unetseg_tpu_torch.infer.tiling": ("TileGrid", "make_tiled_fn", "plan_tiles", "tiled_apply"),
    "unetseg_tpu_torch.infer.folding": ("FoldedUNet", "fold_batchnorm"),
})
