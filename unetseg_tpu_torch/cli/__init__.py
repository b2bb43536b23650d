"""Command-line interface: python -m unetseg_tpu_torch <command> (see main.py)."""
