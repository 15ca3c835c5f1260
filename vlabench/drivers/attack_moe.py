"""The patch attack's driver on a sparse-expert VLA (the DeepSeek-V3
decoder): `drivers/attack.py`'s set-up, outer steps, window and trace as
they are, with parts of its own:
- the program's config, from `common/program_moe.py`;
- the weights: the program's draw, then the correction bias set by
  `common/routing.balance` on seeded frames of their own (the released
  model's bias is learned and keeps the experts' load near even);
- the FLOPs of `common/moe_flops.py` (a token's routed and shared experts,
  not all of them), and the routed experts' bound per inner step
  (`moe_bound_s`, which `attack.moe_roofline_share` reads);
- the reference, `reference/moe.py`, run on the program's expert choice of
  the first outer step (taken by `common/routing.taken`), which also takes
  a fault planted in the sparse-expert layer (`fault`, for
  `calibrate_moe.py`);
- the comparison: `reference/compare.py`'s numbers, and `route_miss`, the
  share of tokens whose experts at the first sparse layer the program chose
  otherwise than the reference.

The base driver reads its config builder, its weight draw and its FLOP
counter by module name (`vla_config`, `init_vla_params`, `flops`); this
driver gives it its own for the length of `setup` and `window`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from roboticattack_torch.attacks import engine
from roboticattack_torch.models.config import torch_dtype
from roboticattack_torch.models.vlm import init_vla_params, vla_forward
from roboticattack_torch.utils.normalization import dual_normalize

from vlabench.common import inputs, moe_flops, program_moe, routing
from vlabench.drivers import attack
from vlabench.reference import compare
from vlabench.reference import moe as ref_moe
from vlabench.reference import vla as ref


@contextlib.contextmanager
def _moe_names(draw=attack.init_vla_params):
    saved = attack.vla_config, attack.flops, attack.init_vla_params
    attack.vla_config, attack.flops, attack.init_vla_params = program_moe.vla_config, moe_flops, draw
    try:
        yield
    finally:
        attack.vla_config, attack.flops, attack.init_vla_params = saved


class Driver(attack.Driver):
    def _draw(self, gen: torch.Generator, vcfg) -> Dict:
        """The program's weights with the correction bias balanced on
        frames drawn from the seed, apart from the attacked ones."""
        params = init_vla_params(gen, vcfg)
        t = self.t
        frames = inputs.batches(self.seed + 1, self.size, t["batch_size"], t["pad_to"])

        def forward():
            b = engine.batch_to_device(engine.AttackBatch(*next(frames)), self.device)
            vla_forward(params, vcfg, b.input_ids, b.attention_mask, dual_normalize(b.images).to(torch_dtype(vcfg)))

        self.balanced = routing.balance(params, forward, self._chosen)
        return params

    def setup(self) -> None:
        with routing.taken() as chosen, _moe_names(self._draw):
            self._chosen = chosen
            super().setup()
        del self._chosen
        layers, inner = self.vcfg.llm.num_moe_layers, self.t["inner_loop"]
        if len(chosen) != inner * layers:
            raise RuntimeError(f"the first outer step made {len(chosen)} expert choices, not one a sparse layer "
                               f"and inner step ({inner * layers})")
        routes = [chosen[i * layers:(i + 1) * layers] for i in range(inner)]
        self.first.update(routes=routes, chosen=[r[0].cpu() for r in routes])

    def window(self, seconds: float, trace: bool) -> Dict:
        with _moe_names():
            rec = super().window(seconds, trace)
        rec["moe_bound_s"] = moe_flops.routed_expert_bound_s(self.cfg, self.t["batch_size"], self.t["pad_to"])
        return rec

    def reference(self, precision=ref.Precision(), rows=None, fault: Optional[str] = None) -> ref_moe.MoeTrace:
        f = self.first
        return ref_moe.attack_steps(self.cfg, self.params, f["batch"], f["patch0"], f["draws"], f["lr"],
                                    self.device, precision, rows, fault, f["routes"])

    @staticmethod
    def readings(first: Dict, trace: ref_moe.MoeTrace) -> Dict[str, float]:
        """`compare.attack_readings`, and `route_miss`: `first["chosen"]`
        (the choice at the first sparse layer, an inner step each) against
        the reference's own."""
        miss = ref_moe.route_miss(first["chosen"], trace.chosen)
        return dict(compare.attack_readings(first, trace), route_miss=miss)

    def check(self) -> Dict[str, Dict[str, float]]:
        return compare.held(self.readings(self.first, self.reference()), self.cell["limits"])
