from unetseg_tpu_torch._exports import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "unetseg_tpu_torch.ops.losses": ("binary_probs_from_logits", "cross_entropy", "per_pixel_ce",
                                     "weighted_cross_entropy"),
    "unetseg_tpu_torch.ops.elastic": ("elastic_deform", "elastic_deform_batch",
                                      "gaussian_blur_2d"),
    "unetseg_tpu_torch.ops.edt": ("distance_transform_edt", "edt", "edt_sq"),  # edt: the module
    "unetseg_tpu_torch.ops.weight_maps": ("weight_map", "weight_map_np", "weight_map_device"),
})
