"""Command-line interface: python -m unetseg_tpu_torch preprocess|train."""
