"""PyTorch + CUDA port of unetseg_tpu: the overlap-tile serving path and
its export, the augmented training loop with its checkpoints and data
parallelism, the weight-map preprocessing, sequence prediction
(ensembles, device connected components, the post-processing chain),
tracking and the CTC measures, with `python -m unetseg_tpu_torch
<command>` (cli/main.py) and the benchmark `python -m unetseg_tpu_torch
bench` (bench.py).

The JAX package (`unetseg_tpu`) is the reference; each module here names
its counterpart there, and tests/test_torch_port_*.py hold the two against
each other on the same inputs. This package imports torch and numpy and
never jax, flax or anything under `unetseg_tpu`. The package and its
subpackages export the JAX package's public names
(tests/test_torch_port_api.py lists the few with no counterpart).

Activations are NHWC at every public function, as in the JAX package. The
Hopper kernels live in `ops/kernels` (sources in `csrc/`, built at first
use, never at import); on a CPU tensor each kernel wrapper runs its plain
PyTorch version instead. Entry points run on the card unless the caller
asks for the CPU.
"""

__version__ = "0.1.0"

# numpy madvises MADV_HUGEPAGE on large buffers; with the host kernel in
# THP defrag=madvise mode every first-touch write fault then does
# synchronous hugepage compaction. The JAX package measured this on its
# own host (np.stack of 84 512^2 frames: 16.8 s vs 0.06 s with this off),
# where it made dataset loading dominate training startup. The env knob
# (NUMPY_MADVISE_HUGEPAGE=0) only works before numpy's first import, and a
# host may pre-import numpy from sitecustomize, so flip the policy through
# numpy's runtime switch as well.
import os as _os

_os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
try:  # numpy >= 2
    from numpy._core import _multiarray_umath as _mu
except ImportError:  # pragma: no cover - numpy 1.x
    try:
        from numpy.core import _multiarray_umath as _mu
    except ImportError:  # pragma: no cover
        _mu = None
if _mu is not None and hasattr(_mu, "_set_madvise_hugepage"):
    _mu._set_madvise_hugepage(False)

from unetseg_tpu_torch.core.config import (  # noqa: E402,F401
    Config,
    DataConfig,
    EvalConfig,
    InferConfig,
    ModelConfig,
    TrackConfig,
    TrainConfig,
)
