"""Data-parallel steps over a mesh of ranks (counterpart of unetseg_tpu/parallel/)."""
