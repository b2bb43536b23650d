"""Traffic kind `train_steps`: the loop's epoch feed around
`make_train_step`'s step. A device-resident set of frames, instance
labels and weight maps; each epoch a permutation of the set, cut into
batches gathered by index_select; the augmentation draws made by the
benchmark, one per step of an epoch, handed in through `draws=`; one
sync per epoch, when its losses come to the host. The traffic file
states the set's size, the batch, the steps an epoch, the recipe's
optimizer, schedule, EMA and augmentation values, the weight maps'
parameters, and the set-up, check and trace counts (README.md).

Set-up builds one train state and one step, runs the first epoch through
the window's own loop, and hands both to the window. The state starts at
epoch `start_epoch` of the recipe's schedule: the step count is that
epoch's first, so the cosine rate and the EMA's decay are the ones of
that point of a run, while the variables, Adam's moments (zero) and the
EMA shadows (the variables) are fresh. The check follows the first
`check_steps` steps with the plain reference from the same state; the
configuration's architecture module names the program's leaves for the
reference (ref_key) and the leaves whose first-gradient errors it reads
(watched).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

import flops
import synth
from harness import model_config, print_phases, profile
from reference import train as ref_train
from reference.common import exact_f32

UNIT = "ubench.step"
NOUGHT = 1e-3  # a leaf whose first reference gradient is under this x the median leaf's


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(tree)
    vals = torch.stack([tree[k].double().norm() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def worst_gap(got: Dict[str, float], want: Dict[str, float], leaves) -> tuple:
    """(max over `leaves` of |got - want| / max(want, the median leaf's
    want), that leaf, its got, its want, the median)."""
    med = statistics.median(want[k] for k in leaves)
    return max((abs(got[k] - want[k]) / max(want[k], med, 1e-30), k, got[k], want[k], med)
               for k in leaves)


class Cell:
    """Set-up of a train_steps cell: data, draws, state, step, one epoch."""

    unit = UNIT

    def __init__(self, spec: Dict[str, Any], device: str, seed: int):
        from unetseg_tpu_torch.core.config import TrainConfig
        from unetseg_tpu_torch.train.state import create_train_state
        from unetseg_tpu_torch.train.steps import AugmentDraws, make_train_step

        self.device = device
        self.model, self.t = spec["config"]["model"], spec["traffic"]
        self.arch = spec["architecture"]
        t, cfg = self.t, spec["config"]
        self.config = cfg
        self.three_class = self.model["num_classes"] == 3
        marks = [("start", time.perf_counter())]
        self.images, self.labels = synth.cell_frames(synth.generator(seed, "frames", device),
                                                     t["frames"], t["size"], device)
        self.weights = synth.weight_maps(self.labels, t["w0"], t["sigma_w"])
        self.raw_draws = synth.augment_draws(synth.generator(seed, "draws", device),
                                             t["steps_per_epoch"], t["batch"], t["size"], t,
                                             device)
        self.draws = [AugmentDraws(**d) for d in self.raw_draws]
        g = synth.generator(seed, "order", device)
        self.orders = [torch.randperm(t["frames"], generator=g, device=device)
                       [:t["steps_per_epoch"] * t["batch"]].view(t["steps_per_epoch"], t["batch"])
                       for _ in range(t["epochs_drawn"])]
        self.valid = torch.ones(t["batch"], dtype=torch.bool, device=device)
        marks.append(("data and draws", time.perf_counter()))
        self.variables = synth.variables(self.arch, self.model, seed, device)
        marks.append(("variables", time.perf_counter()))
        tcfg = TrainConfig(batch_size=t["batch"], num_epochs=t["num_epochs"],
                           learning_rate=t["learning_rate"], optimizer=t["optimizer"],
                           cosine_decay=t["cosine_decay"], ema_decay=t["ema_decay"])
        mcfg = model_config(self.model)
        self.start = t["start_epoch"] * t["steps_per_epoch"]
        state = create_train_state(self.variables, mcfg, tcfg, input_size=t["size"],
                                   steps_per_epoch=t["steps_per_epoch"], device=device)
        self.state = dataclasses.replace(state, step=self.start,
                                         opt_state=dict(state.opt_state, count=self.start))
        # every item is real when the set divides by the batch, as train/loop.py decides
        self.step: Callable = make_train_step(
            mcfg, assume_valid=t["frames"] % t["batch"] == 0, augment=True,
            elastic_alpha=t["elastic_alpha"], elastic_sigma=t["elastic_sigma"],
            three_class=self.three_class, border_boost=cfg.get("border_boost", 1.0),
            standardize=t["standardize"], aug_gamma=t["aug_gamma"], aug_illum=t["aug_illum"],
            aug_noise=t["aug_noise"])
        marks.append(("state and step", time.perf_counter()))
        self.epoch = 0
        self.snap = {0: self.state}
        losses = self.run_epoch(keep=t["check_steps"])
        self.got = self.program_readout(losses[:t["check_steps"]])
        self.snap = {}
        marks.append(("first epoch", time.perf_counter()))
        print_phases(marks)

    def run_epoch(self, keep: int = 0, annotate: bool = False,
                  steps: Optional[int] = None) -> List[float]:
        """One epoch (or its first `steps`) of the feed; ends with the
        losses on the host. `keep` keeps the states after the first
        steps for the check."""
        idx = self.orders[self.epoch % len(self.orders)]
        self.epoch += 1
        losses = []
        for s in range(steps or idx.shape[0]):
            ib = idx[s]
            with torch.profiler.record_function(UNIT) if annotate else contextlib.nullcontext():
                self.state, m = self.step(
                    self.state, self.images.index_select(0, ib), self.labels.index_select(0, ib),
                    self.weights.index_select(0, ib), self.valid, draws=self.draws[s])
            losses.append(m["loss"])
            if s < keep:
                self.snap[s + 1] = self.state
        out = torch.stack(losses).cpu().tolist()
        if not all(v == v and abs(v) < float("inf") for v in out):
            raise RuntimeError(f"a loss of epoch {self.epoch} is not finite: {out}")
        return out

    def window(self, seconds: float) -> Dict[str, Any]:
        start = time.perf_counter()
        steps, ends = 0, []
        while True:
            steps += len(self.run_epoch())
            ends.append(time.perf_counter() - start)
            if ends[-1] >= seconds:
                break
        print(f"epochs end at {[round(e, 3) for e in ends]} s", file=sys.stderr, flush=True)
        return {"window_s": ends[-1], "units": steps, "failed": 0}

    def end_to_end(self, w: Dict[str, Any]) -> Dict[str, float]:
        """train_step_ms, the window's seconds over its steps; on the card
        also train_device_ms, the device's busy milliseconds a step (the
        union of its kernels, copies and sets) over one whole epoch traced
        after the window: the step's time where the host keeps the card
        fed, and steady where the host's own speed is not (PERF.md)."""
        out = {"train_step_ms": w["window_s"] / w["units"] * 1e3}
        if self.device != "cpu":
            summary, n = profile(self.traced_epoch, UNIT)
            out["train_device_ms"] = summary["busy_s"] / n * 1e3
        return out

    def traced_epoch(self) -> int:
        """A whole epoch under the annotation, then one more annotated
        stretch that waits for the card, so that the trace's span holds
        all of the epoch's device work."""
        n = self.traced(self.t["steps_per_epoch"])
        with torch.profiler.record_function(UNIT):
            torch.cuda.synchronize()
        return n

    def traced(self, steps: Optional[int] = None) -> int:
        n = steps or self.t["trace_steps"]
        self.run_epoch(annotate=True, steps=n)
        return n

    def observation(self, w: Dict[str, Any]) -> Dict[str, Any]:
        per = flops.train_step(self.arch, self.model, self.t)
        return {"kind": "train", "window_s": w["window_s"], "units": w["units"],
                "model_flops": per["model_flops"], "bound_s": per["bound_s"]}

    # ------------------------------------------------------------- check
    def batches(self) -> List[tuple]:
        idx = self.orders[0]
        return [(self.images.index_select(0, idx[s]), self.labels.index_select(0, idx[s]),
                 self.weights.index_select(0, idx[s])) for s in range(self.t["check_steps"])]

    def program_readout(self, losses: List[float]) -> Dict[str, Any]:
        """The program's first losses, first gradient (Adam's first moment
        after one step over 1 - b1) and the state after check_steps, by
        leaf norm under the reference's names."""
        k = self.t["check_steps"]
        s0, s1, sk = self.snap[0], self.snap[1], self.snap[k]
        ref_key = self.arch.ref_key
        g1 = {ref_key(n): v / (1 - ref_train.B1) for n, v in s1.opt_state["mu"].items()}

        def change(new, old):
            return norms({ref_key(n): new[n] - old[n] for n in new})

        return {"losses": losses, "grads1": norms(g1), "g1": g1,
                "params": change(sk.params, s0.params), "stats": change(sk.batch_stats,
                                                                         s0.batch_stats),
                "ema": change(sk.ema_params, s0.params),
                "ema_stats": change(sk.ema_batch_stats, s0.batch_stats)}

    def reference_readout(self, quant: Optional[Callable] = None) -> Dict[str, Any]:
        exact_f32()
        params, stats = self.arch.to_tensors(self.variables, self.device)
        t = self.t
        out = ref_train.follow(params, stats, self.batches(), self.raw_draws[:t["check_steps"]],
                               t, t["steps_per_epoch"], self.start, self.arch, self.model,
                               self.three_class, self.config.get("border_halo", 2),
                               self.config.get("border_boost", 1.0), quant)
        tr = out["trainer"]

        def change(new, old):
            return norms({n: new[n] - old[n] for n in new})

        return {"losses": out["losses"], "grads1": norms(out["grads1"]), "g1": out["grads1"],
                "params": change(tr.params, params), "stats": change(tr.stats, stats),
                "ema": change(tr.ema, params), "ema_stats": change(tr.ema_stats, stats)}

    def readings(self) -> Dict[str, float]:
        """Frees the program's state, then holds its readout to the
        reference's: the worst step's relative loss gap; the worst leaf's
        gap of first-gradient norms; the worst leaf's gap of change norms
        after check_steps (parameters, running statistics and both EMA
        shadows); and for each reading the architecture module's `watched`
        names, the first-gradient error of the worst of its leaves: the
        norm of the difference over the reference's norm. Leaves whose
        first reference gradient is nought to rounding are left out of the
        gradients, the parameters and their shadows."""
        got = self.got
        self.state = self.step = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()
        want = self.reference_readout()
        loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
        g = want["grads1"]
        med = statistics.median(g.values())
        moved = [k for k in g if g[k] >= NOUGHT * med]
        grad1 = worst_gap(got["grads1"], g, moved)
        err = norms({k: got["g1"][k] - want["g1"][k] for k in moved})
        change = max((worst_gap(got[grp], want[grp], moved if grp in ("params", "ema")
                                else list(want[grp])) + (grp,))
                     for grp in ("params", "stats", "ema", "ema_stats"))
        self.detail = {"losses": got["losses"], "ref_losses": want["losses"],
                       "nought": sorted(set(g) - set(moved)), "grad1": grad1, "change": change,
                       "err_leaf": {k: err[k] / g[k] for k in moved}}
        print(f"train check: losses {got['losses']} reference {want['losses']}; "
              f"{len(g) - len(moved)} leaves nought to rounding; worst grad1 leaf {grad1[1:]}; "
              f"worst change leaf {change[1:]}", file=sys.stderr, flush=True)
        out = {"loss_gap": loss, "grad1_gap": grad1[0], "change_gap": change[0]}
        for name, leaves in self.arch.watched(self.model).items():
            out[name] = max(err[k] / g[k] for k in leaves)
        return out

