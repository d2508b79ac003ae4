"""Driver of the CNN configurations: the program's ``cnn_forward`` over
plans programmed once with ``plan_cnn_weights``, in a closed loop of
batches.

Set-up draws the weights from the seed on the device
(:func:`bench.reference.cnn.draw_weights`), programs them on the
configuration's substrate and runs one batch twice (the kernels build and
load there). The window sends a batch when the previous batch's logits
are on the host, until ``--seconds`` have passed; a batch counts when its
logits arrived inside the window. Afterwards a sample of the window's
batches, drawn from the seed, is run again through the plain reference
and compared.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from bench import yardstick
from bench.reference import cnn as ref

DRIVER_LABELS = ("bench.batch",)


def port_layers(table: List[Dict]):
    """The benchmark's layer table as the program's layer specs."""
    from repro_torch.core.workloads import ConvSpec, DenseSpec
    out = []
    for l in table:
        if l["kind"] == "conv":
            out.append(ConvSpec(l["name"], l["in_hw"], l["in_hw"], l["in_c"],
                                l["out_c"], l["k"], l["k"],
                                stride=l["stride"],
                                residual_add=l["role"] == "c2"))
        else:
            out.append(DenseSpec(l["name"], l["in_f"], l["out_f"]))
    return out


class System:
    """The program under test for one run of a CNN cell."""

    def __init__(self, cell, seed: int, device: str, log, t0: float):
        self.cell, self.seed, self.log, self.t0 = cell, seed, log, t0
        self.device = torch.device(device)
        self.model = cell.config["model"]
        self.traffic = cell.traffic
        self.table = ref.layer_table(self.model)

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core.pim import PimConfig
        from repro_torch.models import cnn
        q = self.cell.config["quantization"]
        self.pim = PimConfig(weight_bits=q["weight_bits"],
                             act_bits=q["act_bits"],
                             substrate=q["substrate"])
        self.cnn = cnn
        self.layers = port_layers(self.table)
        self.params = ref.draw_weights(self.table, self.seed, self.device)
        self.plans = cnn.plan_cnn_weights(self.params, self.layers, self.pim)
        x = self.images(0)
        for _ in range(2):
            self.forward(x).cpu()

    def images(self, index: int) -> torch.Tensor:
        t = self.traffic
        return ref.draw_images(self.seed, index, t["batch"],
                               self.model["image_hw"], self.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cnn.cnn_forward(self.params, self.layers, x,
                                    pim=self.pim, plans=self.plans)

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float, tracer) -> Dict[str, Any]:
        from torch.profiler import record_function
        t = self.traffic
        traced = t["trace_batches"]
        sent: List[Tuple[float, float]] = []     # (send, logits on host)
        self.logits: Dict[int, np.ndarray] = {}
        start = time.perf_counter()
        end = start + seconds
        self.setup_s = start - self.t0
        stretch = None
        i = 0
        while True:
            x = self.images(i)
            if i == 0 and tracer.enabled:
                # the stretch holds the profiler's start and stop
                stretch = [time.perf_counter(), end]
                tracer.start()
            if i == traced and stretch is not None:
                tracer.stop()
                stretch[1] = time.perf_counter()
            now = time.perf_counter()
            if now >= end:
                break
            with record_function("bench.batch"):
                out = self.forward(x)
                host = out.cpu().numpy()
            done = time.perf_counter()
            sent.append((now, done))
            self.logits[i] = host
            i += 1
        done_in = [(s, d) for s, d in sent if d <= end]
        self.counted = len(done_in)
        lat = [(d - s) * 1e3 for s, d in done_in]
        images = self.counted * t["batch"]
        macs = yardstick.cnn_macs(self.table)
        e2e = {"setup_s": self.setup_s,
               "images_per_s": images / seconds}
        if lat:
            e2e["batch_ms_p95"] = yardstick.percentile(lat, 95)
        # the per-layer host readings leave the profiled stretch out
        host = yardstick.HostWindow(start, end, stretch)
        self.log(f"window: {self.counted} batches of {t['batch']} in "
                 f"{seconds} s ({len(sent) - self.counted} finished after "
                 f"its close), set-up {self.setup_s:.3f} s")
        return {"end_to_end": e2e, "attempted": len(sent), "failed": 0,
                "seconds": seconds, "host": host,
                "host_images": t["batch"] * sum(1 for _, d in done_in
                                                if host.holds(d)),
                "images": images, "batches": self.counted,
                "traced_batches": min(traced, self.counted),
                "macs_per_image": macs, "batch": t["batch"],
                "latencies_ms": lat}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.plans = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    # -- the check ------------------------------------------------------------
    def sample(self) -> List[int]:
        """Batches of the window to compare, drawn from the seed."""
        done = sorted(self.logits)[:self.counted]
        rng = np.random.default_rng(self.seed)
        k = min(self.traffic["check_batches"], len(done))
        return sorted(int(i) for i in rng.choice(done, size=k,
                                                 replace=False))

    def readings(self, control: bool = False) -> Dict[str, float]:
        """``logit_gap``: the widest gap between the program's logits and
        the reference's over the sampled batches, as a share of the
        largest reference logit; with ``control``, ``control_gap``: the
        same for the reference computed in bfloat16 in the program's
        place."""
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        q = self.cell.config["quantization"]
        bits = {"weight": q["weight_bits"], "act": q["act_bits"]}
        reference = ref.Reference(self.table, self.params, bits)
        low = ref.Reference(self.table, self.params, bits,
                            dtype=torch.bfloat16) if control else None
        gap = cgap = top = 0.0
        # a NaN reads as the widest gap of all
        widest = lambda d: float(torch.nan_to_num(d.abs(), nan=math.inf).max())
        for i in self.sample():
            x = self.images(i)
            want = reference.forward(x)
            got = torch.from_numpy(self.logits[i]).to(want.device)
            gap = max(gap, widest(got - want))
            top = max(top, float(want.abs().max()))
            if low is not None:
                cgap = max(cgap, widest(low.forward(x) - want))
        out = {"logit_gap": gap / top if top > 0 else float("inf")}
        if control:
            out["control_gap"] = cgap / top if top > 0 else float("inf")
        return out

    def check(self) -> Tuple[Dict, bool]:
        limit = self.cell.config["correct"]["logit_gap"]
        value = self.readings()["logit_gap"]
        checks = {"logit_gap": {"value": value, "limit": limit}}
        return checks, bool(value <= limit) and self.counted > 0
