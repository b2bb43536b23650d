"""Traffic kind `serve_tiles`: one caller in a closed loop sends a batch of
frames (numpy, host memory) to `Predictor.masks_tiled` and waits for the
uint8 masks in host memory; the next call goes out when the last one is
back. Calls take the pool's batches in turn. The traffic file states the
frames per call and their size, the tile input and tile batch, the
members of the ensemble, the TTA and the merges, the input's
standardisation, the threshold, the planted intensity path, the name
of the cell's rate metric, and the set-up, check and trace counts
(README.md).
"""

from __future__ import annotations

import gc
import random
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import flops
import synth
from harness import model_config, print_phases
from reference import serve as ref_serve
from reference.common import exact_f32

UNIT = "ubench.call"


class Cell:
    """Set-up of a serve_tiles cell: the members' variables (planted by the
    architecture module), the Predictor, the pool of frame batches, the
    warm-up calls."""

    unit = UNIT

    def __init__(self, spec: Dict[str, Any], device: str, seed: int):
        from unetseg_tpu_torch.core.config import InferConfig
        from unetseg_tpu_torch.infer.engine import Predictor

        self.device = device
        self.model, self.t = spec["config"]["model"], spec["traffic"]
        self.arch = spec["architecture"]
        t = self.t
        plant = t["plant"]
        marks = [("start", time.perf_counter())]
        self.variables = [self.arch.plant_intensity_path(
            synth.variables(self.arch, self.model, seed, device, tag=f"member{m}"), **plant)
            for m in range(t["members"])]
        marks.append(("variables", time.perf_counter()))
        frames, _ = synth.cell_frames(synth.generator(seed, "frames", device),
                                      t["pool_batches"] * t["frames"], t["size"], device)
        host = frames.cpu().numpy()
        self.batches = [np.ascontiguousarray(host[i * t["frames"]:(i + 1) * t["frames"]])
                        for i in range(t["pool_batches"])]
        icfg = InferConfig(tile_input=t["tile_input"], tile_batch=t["tile_batch"], tta=t["tta"],
                           tta_merge=t["tta_merge"], ensemble_merge=t["ensemble_merge"],
                           standardize=t["standardize"], threshold=t["threshold"])
        members = self.variables if len(self.variables) > 1 else self.variables[0]
        marks.append(("frames", time.perf_counter()))
        self.predictor = Predictor(model_config(self.model), members, icfg, device)
        self.serve: Callable[[np.ndarray], np.ndarray] = self.predictor.masks_tiled
        marks.append(("predictor", time.perf_counter()))
        for i in range(t["warmup_calls"]):
            self.serve(self.batches[i % len(self.batches)])
            marks.append((f"warm-up call {i}", time.perf_counter()))
        print_phases(marks)
        self.kept: List[tuple] = []  # (call index, batch index, masks) of the sampled calls
        self._pick = random.Random(synth.sub_seed(seed, "check"))

    def _keep(self, i: int, b: int, masks: np.ndarray) -> None:
        """Reservoir sample of check_calls calls over the whole window."""
        k = self.t["check_calls"]
        if i < k:
            self.kept.append((i, b, masks))
        else:
            j = self._pick.randint(0, i)
            if j < k:
                self.kept[j] = (i, b, masks)

    def window(self, seconds: float) -> Dict[str, Any]:
        lat: List[float] = []
        start = time.perf_counter()
        i = 0
        while True:
            b = i % len(self.batches)
            t0 = time.perf_counter()
            masks = self.serve(self.batches[b])
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            self._keep(i, b, masks)
            i += 1
            if t1 - start >= seconds:
                break
        return {"window_s": t1 - start, "units": i, "failed": 0, "latencies": lat}

    def end_to_end(self, w: Dict[str, Any]) -> Dict[str, float]:
        t = self.t
        pixels = w["units"] * t["frames"] * t["size"] * t["size"]
        return {t["rate_metric"]: pixels / 1e6 / w["window_s"],
                "seg_call_p95_ms": float(np.percentile(w["latencies"], 95)) * 1e3}

    def traced(self) -> int:
        n = self.t["trace_calls"]
        for i in range(n):
            with torch.profiler.record_function(UNIT):
                self.serve(self.batches[i % len(self.batches)])
        return n

    def observation(self, w: Dict[str, Any]) -> Dict[str, Any]:
        per = flops.serve_call(self.arch, self.model, self.t)
        return {"kind": "serve", "window_s": w["window_s"], "units": w["units"],
                "model_flops": per["model_flops"], "bound_s": per["bound_s"]}

    def reference(self, frames: np.ndarray, quant: Optional[Callable] = None):
        """The reference's (uint8 masks, mean foreground probability) of a
        batch of frames, on the host."""
        t = self.t
        exact_f32()
        nets = ref_serve.nets_from(self.arch, self.variables, self.device)
        x = torch.from_numpy(frames).to(self.device)
        masks, soft = ref_serve.masks(x, nets, self.arch, self.model, t["tile_input"], t["tta"],
                                      t["tta_merge"], t["ensemble_merge"], t["standardize"],
                                      t["threshold"], block=t["reference_block"], quant=quant)
        return masks.cpu().numpy(), soft.cpu().numpy()

    def readings(self) -> Dict[str, float]:
        """Frees the program, then compares the sampled calls' masks with
        the reference's. A pixel is in the band where the reference's
        foreground probability, averaged over members and flips, lies
        within `band` of the threshold: there rounding may flip a mask,
        and the share of band pixels that differ grows with the rounding
        error. Off the band a sound run's masks all but never differ (a
        vote can still turn where members straddle the threshold while
        their mean does not). -> mask_mismatch,
        the share of off-band pixels that differ; band_flips, the share
        of band pixels that differ."""
        self.predictor = self.serve = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()
        ref: Dict[int, tuple] = {}
        off = off_n = flips = band_n = 0
        for _, b, masks in self.kept:
            if b not in ref:
                ref[b] = self.reference(self.batches[b])
            want, soft = ref[b]
            band = np.abs(soft - self.t["threshold"]) < self.t["band"]
            wrong = (masks != want if masks.shape == want.shape and masks.dtype == np.uint8
                     else np.ones_like(band))
            off += int((wrong & ~band).sum())
            off_n += int((~band).sum())
            flips += int((wrong & band).sum())
            band_n += int(band.sum())
        print(f"serve check: {band_n} band pixels of {band_n + off_n} sampled; {flips} band "
              f"and {off} off-band pixels differ", file=sys.stderr, flush=True)
        return {"mask_mismatch": off / max(off_n, 1), "band_flips": flips / max(band_n, 1)}
