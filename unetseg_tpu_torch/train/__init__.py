"""The train step and its state (counterpart of unetseg_tpu/train/)."""
