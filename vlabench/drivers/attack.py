"""The patch attack's driver: outer steps of the program's attack step, fed
as its attack runner feeds them.

Set-up draws the weights on the device from the seed, builds the step
(`attacks/engine.make_attack_step`) and its state, and runs the first outer
step through the same call and feed as the window; that step warms up every
shape the window uses, and its losses and resulting patch and optimizer
state are what the reference follows. The window then runs whole outer
steps, each as the runner runs one: the batch staged by the host
prefetcher, the step's patch draws (the program's `draw_step`) and the
learning rate of the schedule, the step, the next batch's copy staged while
the step runs, and a synchronize. A traced run profiles two more outer steps after the window.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import torch

from roboticattack_torch.attacks import engine
from roboticattack_torch.attacks.optimizer import adam_init, cosine_schedule_with_warmup
from roboticattack_torch.data.prefetch import host_prefetch
from roboticattack_torch.models.vlm import init_vla_params

from vlabench.common import flops, inputs
from vlabench.common.program import vla_config
from vlabench.common.trace import DeviceTrace
from vlabench.reference import compare
from vlabench.reference import vla as ref


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, cell: Dict, seed: int, device: torch.device):
        self.cfg, self.t, self.cell, self.seed, self.device = cfg, traffic, cell, seed, device
        self.size = cfg["vision"]["towers"][0]["image_size"]
        self.spec = engine.AttackSpec(objective=traffic["objective"], geometry=traffic["geometry"],
                                      inner_loop=traffic["inner_loop"], optimizer="adamW",
                                      mse_weight=traffic["mse_weight"], add_inverse_ce=traffic["add_inverse_ce"])

    def _lr(self, i: int) -> float:
        t = self.t
        return cosine_schedule_with_warmup(i, t["lr"], t["warmup"], t["schedule_steps"])

    def _draws(self, i: int) -> engine.StepDraws:
        """Outer step i's draws by the program's own `draw_step`, seeded as
        the attack runner seeds it; the reference gets the benchmark's copy
        (`inputs.step_draws`), so the comparison holds the two equal."""
        t = self.t
        b, n = t["batch_size"], self.size
        return engine.draw_step(torch.Generator().manual_seed(self.seed * 1000003 + i), self.spec, (b, n, n, 3),
                                (t["patch"], t["patch"]), (b, t["pad_to"]))

    def _next(self):
        nb = next(self.batches)
        return nb, engine.batch_to_device(engine.AttackBatch(*nb), self.device, non_blocking=True)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        t = self.t
        self.vcfg = vla_config(self.cfg)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.params = init_vla_params(gen, self.vcfg)
        self.step = engine.make_attack_step(self.spec, self.vcfg, None, t["maskidx"])
        patch = inputs.initial_patch(self.seed, t["patch"]).to(self.device)
        self.state = engine.AttackState(patch=patch, opt=adam_init(patch), grad_acc=torch.zeros_like(patch))
        self.batches = host_prefetch(inputs.batches(self.seed, self.size, t["batch_size"], t["pad_to"]), depth=2)
        # the first outer step: the window's call and feed, followed by the reference
        host0, batch0 = self._next()
        self.first = {"patch0": patch.detach().cpu().clone(), "batch": host0, "lr": self._lr(0),
                      "draws": inputs.step_draws(self.seed, 0, t["inner_loop"], t["batch_size"], self.size,
                                                 t["patch"])}
        self.state, metrics = self.step(self.params, self.state, batch0, self.first["lr"], True, self._draws(0))
        self.staged = self._next()
        self._sync()
        st = self.state
        self.first.update(losses=metrics["loss"].float().cpu().tolist(), patch=st.patch.detach().cpu().clone(),
                          m=st.opt.m.detach().cpu().clone(), v=st.opt.v.detach().cpu().clone())
        self.outer = 1

    def _outer_step(self) -> None:
        """One outer step as the attack runner runs it, in spans of the
        benchmark's own that the trace's idle gaps are named by."""
        _, batch = self.staged
        with torch.profiler.record_function("vlabench.draws"):
            lr, draws = self._lr(self.outer), self._draws(self.outer)
        with torch.profiler.record_function("vlabench.step"):
            self.state, _ = self.step(self.params, self.state, batch, lr, True, draws)
        with torch.profiler.record_function("vlabench.next_batch"):
            self.staged = self._next()
        with torch.profiler.record_function("vlabench.sync"):
            self._sync()
        self.outer += 1

    def window(self, seconds: float, trace: bool) -> Dict:
        """Whole outer steps until `seconds` have passed; with `trace`, two
        more after the window under the profiler: the first gives the busy
        time and the kernels, the second names the idle gaps."""
        times = []
        self._sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            a = time.perf_counter()
            self._outer_step()
            times.append(time.perf_counter() - a)
        window_s = time.perf_counter() - t0
        steps = len(times) * self.t["inner_loop"]
        print(f"window: {len(times)} outer steps in {window_s:.3f} s, each "
              + " ".join(f"{x:.3f}" for x in times), file=sys.stderr)
        summary = None
        if trace:  # two more outer steps: device activity alone, then with the host's
            with DeviceTrace(host=False) as device:
                self._outer_step()
            with DeviceTrace(host=True) as ops:
                self._outer_step()
            summary = device.reduce()
            summary.gaps = ops.reduce().gaps
        return {"attempted": steps, "failed": 0, "window_s": window_s, "inner_steps": steps,
                "outer_s": times, "inner_loop": self.t["inner_loop"], "trace": summary,
                "flops_per_inner_step": flops.attack_inner_step(self.cfg, self.t["batch_size"], self.t["pad_to"]),
                "peak_flops": flops.PEAK_BF16_FLOPS}

    def end_to_end(self, rec: Dict) -> Dict[str, float]:
        return {"attack_steps_per_s": rec["inner_steps"] / rec["window_s"]}

    def release(self) -> None:
        """Frees the program's state; the weights (the benchmark's own draw)
        stay for the reference."""
        self.batches.close()
        del self.state, self.staged, self.step
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision=ref.Precision(), rows=None) -> ref.AttackTrace:
        f = self.first
        return ref.attack_steps(self.cfg, self.params, f["batch"], f["patch0"], f["draws"], f["lr"], self.device,
                                precision, rows)

    def check(self) -> Dict[str, Dict[str, float]]:
        return compare.attack_checks(self.first, self.reference(), self.cell["limits"])

