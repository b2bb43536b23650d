"""Overlays and panels (counterpart of unetseg_tpu/viz)."""
