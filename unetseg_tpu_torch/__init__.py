"""PyTorch + CUDA port of unetseg_tpu: the overlap-tile serving path, the
augmented training loop with its checkpoints, the weight-map
preprocessing, and sequence prediction (ensembles, device connected
components, the post-processing chain), with
`python -m unetseg_tpu_torch preprocess|train|infer|predict|refine`.

The JAX package (`unetseg_tpu`) is the reference; each module here names
its counterpart there, and tests/test_torch_port_*.py hold the two against
each other on the same inputs. This package imports torch and numpy and
never jax, flax or anything under `unetseg_tpu`.

Activations are NHWC at every public function, as in the JAX package. The
Hopper kernels of the serving path live in `ops/kernels` (sources in
`csrc/`); on a CPU tensor each kernel wrapper runs its plain PyTorch
version instead. Entry points run on the card unless the caller asks for
the CPU.
"""
