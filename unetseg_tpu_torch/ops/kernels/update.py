"""The train step's update as passes over flat f32 buffers: the layout,
the packed trees, the wrappers, their plain versions and launch counters.

No TPU kernel is replaced: the JAX package's update is optax under jit,
which XLA fuses. The plain update (`update_plain`, `ema_plain`,
`global_norm_plain`) is the port's `_foreach` code, some 300 operator
calls a step over the default net's 82 leaves; it runs on the CPU. On the
card `fused_update` makes one pass over every parameter element (the
optimizer step and the gradient's global norm) and `fused_ema` one over
each EMA shadow (csrc/fused_update.cu).

The kernels read and write `FlatTensors`: a dict of per-leaf views, in its
`FlatLayout`'s key order, into one flat f32 buffer whose leaves start at
multiples of ALIGN elements (the padding between them is never read).
Each update writes new buffers, so a tree that a caller keeps never
changes under it. Gradients, and the values an EMA follows, are read in
place through a table of pointers; a leaf that is not contiguous f32 is
copied first (counted, for both wrappers, in `fused_update.restrided`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Iterable, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from unetseg_tpu_torch.ops.kernels.build import library
from unetseg_tpu_torch.ops.kernels.conv3x3 import _on_cpu, _raise_on, _stream
from unetseg_tpu_torch.ops.kernels.launches import counted

ALIGN = 128    # elements: each leaf starts 512 bytes into a 512-byte-aligned buffer
CHUNK = 4096   # elements a block of csrc/fused_update.cu takes
KINDS = {"sgd": 0, "adam": 1, "adamw": 2}
Tensors = Mapping[str, torch.Tensor]


class UpdateScalars(NamedTuple):
    """The host's scalars of one optimizer step (train/state.Optimizer
    .scalars), as Python floats that the plain path hands to `_foreach`
    and the kernel takes rounded to f32, as PyTorch rounds them."""

    step: float                 # -lr(count)
    momentum: float = 0.0       # sgd
    b1: float = 0.0             # adam, adamw
    b2: float = 0.0
    inv_c1: float = 1.0         # 1 / (1 - b1 ** (count + 1)), an f32 value
    inv_c2: float = 1.0
    eps: float = 0.0
    weight_decay: float = 0.0   # adamw


@dataclasses.dataclass(frozen=True, eq=False)
class FlatLayout:
    """Where each leaf of a tree lies in a flat buffer: keys in order,
    shapes, element offsets (multiples of ALIGN) and the buffer's size.
    `FlatLayout.of` gives equal trees one layout object, so that a packed
    tree is recognised as matching by identity."""

    keys: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    numels: Tuple[int, ...]
    size: int
    blocks: int       # blocks of one pass: sum of ceil(numel / CHUNK)

    @staticmethod
    def of(tree: Tensors) -> "FlatLayout":
        return _layout(tuple((k, tuple(v.shape)) for k, v in tree.items()))

    @functools.cached_property
    def strides(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(torch.empty(s, device="meta").stride() for s in self.shapes)

    @functools.cached_property
    def c_offsets(self):
        return (ctypes.c_longlong * len(self.keys))(*self.offsets)

    @functools.cached_property
    def c_numels(self):
        return (ctypes.c_longlong * len(self.keys))(*self.numels)


@functools.lru_cache(maxsize=64)
def _layout(leaves: Tuple[Tuple[str, Tuple[int, ...]], ...]) -> FlatLayout:
    offsets, numels, at = [], [], 0
    for _, shape in leaves:
        n = 1
        for d in shape:
            n *= d
        offsets.append(at)
        numels.append(n)
        at += -(-n // ALIGN) * ALIGN
    return FlatLayout(tuple(k for k, _ in leaves), tuple(s for _, s in leaves), tuple(offsets),
                      tuple(numels), at, sum(-(-n // CHUNK) for n in numels))


def _detaching(name: str):
    base = getattr(dict, name)

    def method(self, *args, **kwargs):
        self.flat = None
        return base(self, *args, **kwargs)

    method.__name__ = name
    return method


class FlatTensors(dict):
    """Per-leaf views, in `layout`'s key order, into the flat f32 buffer
    `flat`. A change to the dict itself (not to a tensor) cuts it loose:
    `flat` becomes None, and the next update packs it anew."""

    def __init__(self, flat: torch.Tensor, layout: FlatLayout):
        super().__init__(zip(layout.keys, [
            flat.as_strided(s, st, o)
            for s, st, o in zip(layout.shapes, layout.strides, layout.offsets)]))
        self.flat: Optional[torch.Tensor] = flat
        self.layout = layout

    __setitem__ = _detaching("__setitem__")
    __delitem__ = _detaching("__delitem__")
    __ior__ = _detaching("__ior__")
    clear = _detaching("clear")
    pop = _detaching("pop")
    popitem = _detaching("popitem")
    setdefault = _detaching("setdefault")
    update = _detaching("update")


def is_packed(tree: Tensors, layout: Optional[FlatLayout] = None) -> bool:
    """True for FlatTensors still backed by their buffer (and laid out by
    `layout` when given): a constant-cost check."""
    return (isinstance(tree, FlatTensors) and tree.flat is not None
            and (layout is None or tree.layout is layout))


def pack(tree: Tensors, layout: Optional[FlatLayout] = None) -> FlatTensors:
    """A packed copy of `tree` (f32 leaves), laid out by `layout` or by its
    own keys and shapes."""
    layout = layout or FlatLayout.of(tree)
    leaves = _leaves("pack", tree, layout)
    if any(t.dtype != torch.float32 for t in leaves):
        raise TypeError("pack: leaves must be float32")
    out = FlatTensors(torch.zeros(layout.size, dtype=torch.float32, device=leaves[0].device),
                      layout)
    torch._foreach_copy_(list(out.values()), leaves)
    return out


def _leaves(name: str, tree: Tensors, layout: FlatLayout) -> List[torch.Tensor]:
    if len(tree) != len(layout.keys):
        raise ValueError(f"{name}: {len(tree)} leaves, the layout has {len(layout.keys)}")
    out = []
    for k, shape in zip(layout.keys, layout.shapes):
        t = tree[k]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, the layout {shape}")
        out.append(t)
    return out


def _new_like(tree: FlatTensors) -> FlatTensors:
    return FlatTensors(torch.empty_like(tree.flat), tree.layout)


def update_plain(kind: str, p: List[torch.Tensor], g: List[torch.Tensor],
                 moments: Sequence[List[torch.Tensor]], h: UpdateScalars):
    """optax's step over leaf lists -> (new params, [new moments]); the
    moments are (trace,) for sgd and (mu, nu) for adam and adamw."""
    if kind == "sgd":
        tr = torch._foreach_add(g, torch._foreach_mul(moments[0], h.momentum))
        upd = torch._foreach_mul(tr, h.step)
        return torch._foreach_add(p, upd), [tr]
    if kind not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {kind!r}")
    mu = torch._foreach_add(torch._foreach_mul(g, 1 - h.b1), torch._foreach_mul(moments[0], h.b1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - h.b2),
                            torch._foreach_mul(moments[1], h.b2))
    # the bias corrections as products with their f32 reciprocals: what
    # `_foreach_div` by a scalar computes on the card (true division on the
    # CPU), so that the bits do not depend on the device
    mu_hat = torch._foreach_mul(mu, h.inv_c1)
    nu_hat = torch._foreach_mul(nu, h.inv_c2)
    den = torch._foreach_add(torch._foreach_sqrt(nu_hat), h.eps)
    upd = torch._foreach_div(mu_hat, den)
    if kind == "adamw":
        upd = torch._foreach_add(upd, torch._foreach_mul(p, h.weight_decay))
    upd = torch._foreach_mul(upd, h.step)
    return torch._foreach_add(p, upd), [mu, nu]


def ema_plain(e: List[torch.Tensor], new: List[torch.Tensor], one_minus_d: float
              ) -> List[torch.Tensor]:
    """e + (new - e) * (1 - d) over leaf lists, new cast to e's dtype."""
    diff = torch._foreach_sub([n.to(x.dtype) for n, x in zip(new, e)], e)
    return torch._foreach_add(e, torch._foreach_mul(diff, one_minus_d))


def global_norm_plain(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves))


def _pointers(name: str, tree: Tensors, layout: FlatLayout, device: torch.device, keep: list):
    """The table of `tree`'s leaf pointers in `layout` order; a leaf that
    is not contiguous f32 is copied as such (kept alive in `keep`) and
    counted."""
    if is_packed(tree, layout) and tree.flat.device == device:
        base = tree.flat.data_ptr()
        return (ctypes.c_longlong * len(layout.keys))(*[base + 4 * o for o in layout.offsets])
    ptrs = []
    for t in _leaves(name, tree, layout):
        if t.device != device:
            raise ValueError(f"{name}: a leaf on {t.device}, the state on {device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            t = t.float().contiguous()
            fused_update.restrided += 1
        keep.append(t)
        ptrs.append(t.data_ptr())
    return (ctypes.c_longlong * len(ptrs))(*ptrs)


@counted
def fused_update(kind: str, params: FlatTensors, grads: Tensors,
                 moments: Sequence[FlatTensors], h: UpdateScalars
                 ) -> Tuple[FlatTensors, List[FlatTensors], torch.Tensor]:
    """One optimizer step of packed `params` and `moments` ((trace,) or
    (mu, nu), in params' layout) by `grads` (name -> f32 tensor) ->
    (new params, [new moments], the gradients' global norm as a 0-d f32
    tensor on their device). Inputs are left as they were."""
    if not is_packed(params) or not all(is_packed(m, params.layout) for m in moments):
        raise ValueError("fused_update: params and moments must be packed in one layout")
    if len(moments) != (1 if kind == "sgd" else 2):
        raise ValueError(f"fused_update: {kind} takes {1 if kind == 'sgd' else 2} moments")
    layout = params.layout
    if _on_cpu(params.flat, *(m.flat for m in moments)):
        g = _leaves("fused_update", grads, layout)
        p, ms = update_plain(kind, list(params.values()), g,
                             [list(m.values()) for m in moments], h)
        return (pack(dict(zip(layout.keys, p)), layout),
                [pack(dict(zip(layout.keys, m)), layout) for m in ms], global_norm_plain(g))
    keep: list = []
    gptr = _pointers("fused_update", grads, layout, params.flat.device, keep)
    new_p, new_ms = _new_like(params), [_new_like(m) for m in moments]
    partials = torch.empty(layout.blocks, dtype=torch.float64, device=params.flat.device)
    norm = torch.empty((), dtype=torch.float32, device=params.flat.device)
    two = len(moments) == 2
    scalars = (ctypes.c_float * 10)(h.step, h.momentum, 1 - h.b1, h.b1, 1 - h.b2, h.b2,
                                    h.inv_c1, h.inv_c2, h.eps, h.weight_decay)
    err = library().fused_update_f32(
        KINDS[kind], len(layout.keys), gptr, layout.c_offsets, layout.c_numels,
        params.flat.data_ptr(), moments[0].flat.data_ptr(),
        moments[1].flat.data_ptr() if two else None,
        new_p.flat.data_ptr(), new_ms[0].flat.data_ptr(),
        new_ms[1].flat.data_ptr() if two else None,
        scalars, partials.data_ptr(), layout.blocks, norm.data_ptr(), _stream(params.flat))
    _raise_on(err, "fused_update")
    fused_update.launches += 1
    return new_p, new_ms, norm


fused_update.restrided = 0


@counted
def fused_ema(shadow: FlatTensors, new: Tensors, one_minus_d: float) -> FlatTensors:
    """The EMA step of a packed `shadow` towards `new` (name -> tensor in
    the shadow's layout, packed or not): shadow + (new - shadow) * (1 - d)
    as new FlatTensors."""
    if not is_packed(shadow):
        raise ValueError("fused_ema: the shadow must be packed")
    layout = shadow.layout
    if _on_cpu(shadow.flat):
        e = ema_plain(list(shadow.values()), _leaves("fused_ema", new, layout), one_minus_d)
        return pack(dict(zip(layout.keys, e)), layout)
    keep: list = []
    ptrs = _pointers("fused_ema", new, layout, shadow.flat.device, keep)
    out = _new_like(shadow)
    err = library().fused_ema_f32(len(layout.keys), ptrs, layout.c_offsets, layout.c_numels,
                                  shadow.flat.data_ptr(), out.flat.data_ptr(), one_minus_d,
                                  _stream(shadow.flat))
    _raise_on(err, "fused_ema")
    fused_ema.launches += 1
    return out
