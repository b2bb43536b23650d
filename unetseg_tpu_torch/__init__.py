"""PyTorch + CUDA port of unetseg_tpu's overlap-tile inference path.

The JAX package (`unetseg_tpu`) is the reference; each module here names
its counterpart there, and tests/test_torch_port_*.py hold the two against
each other on the same inputs. This package imports torch and numpy and
never jax, flax or anything under `unetseg_tpu`.

Activations are NHWC at every public function, as in the JAX package. The
Hopper kernels of the serving path live in `ops/kernels` (sources in
`csrc/`); on a CPU tensor each kernel wrapper runs its plain PyTorch
version instead.
"""
