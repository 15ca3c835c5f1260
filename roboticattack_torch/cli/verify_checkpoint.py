"""One-command real-checkpoint acceptance: manifest -> parity -> smoke -> quant.

    python -m roboticattack_torch.cli.verify_checkpoint --model openvla-7b
    python -m roboticattack_torch.cli.verify_checkpoint --checkpoint /path/to/dir

Wraps models/verify.py around the checkpoint: a local `--checkpoint`
directory, or the registry's hub download of `--model` (`models/registry.py`),
then

1. MANIFEST — tensor names/shapes/dtypes vs the config-derived golden
   manifest, from safetensors headers only (seconds; fails fast),
2. PARITY — per-module + full-stack activation parity of the port's
   converted tree vs transformers modules built independently from the raw
   checkpoint, in true fp32 (TF32 off) on `--device`; `--modules` runs the
   legs one at a time where memory is short,
3. SMOKE — a short TMA attack on synthetic frames at the model's dtype: loss
   must descend and a patch artifact is written,
4. QUANT — greedy-decode token agreement of quantized serving
   configurations (`--quant-modes`, e.g. int4+qk for the CUDA int4 kernel)
   against the full-precision decode; the int8 row gates at
   --quant-min-agreement.

Exit code 0 iff every requested step passes; a JSON report and the smoke
patch land in --output. The flags are the JAX CLI's with `--device
cuda|cpu` (default cuda; without a GPU it raises unless given `--device
cpu`). `--quant-tp` picks the int4 group size of the tensor-parallel degree
you will deploy with (the decode itself runs in one process).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="openvla-7b",
                   help="registry model ID (see models.registry.available_model_names)")
    p.add_argument("--checkpoint", default=None,
                   help="local checkpoint dir (skips the HF-Hub download)")
    p.add_argument("--steps", default="manifest,parity,smoke,quant",
                   help="comma-separated subset of manifest,parity,smoke,quant")
    p.add_argument("--modules", default="dino,siglip,projector,llm,full",
                   help="parity modules (comma-separated)")
    p.add_argument("--parity-batch", type=int, default=2)
    p.add_argument("--parity-seq", type=int, default=24)
    p.add_argument("--parity-rel-tol", type=float, default=2e-2)
    p.add_argument("--smoke-iters", type=int, default=20)
    p.add_argument("--smoke-bs", type=int, default=2)
    p.add_argument("--smoke-lr", type=float, default=5e-2)
    p.add_argument("--quant-modes", default="int8,w8a8,int4,int8+kv8,int4+kv4",
                   help="serving configs to compare against the full-"
                        "precision decode: <int8|w8a8|int4|none>[+kv8|kv4]"
                        "[+vt<k>][+qk]")
    p.add_argument("--quant-tp", type=int, default=1,
                   help="the tensor-parallel degree you will deploy with: "
                        "int4's group size depends on it (7B tp=4 serves "
                        "gs=64, not 128), and the gate must test the "
                        "quantization that will be served")
    p.add_argument("--quant-min-agreement", type=float, default=0.9,
                   help="token-agreement gate, applied to the int8 mode")
    p.add_argument("--output", default=None,
                   help="report/artifact dir (default: verify_<model>/)")
    p.add_argument("--cache_dir", default=None)
    p.add_argument("--hf_token", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every leg runs; parity in fp32 with TF32 off")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    steps = [s.strip() for s in args.steps.split(",") if s.strip()]
    modules = tuple(m.strip() for m in args.modules.split(",") if m.strip())
    quant_modes = [m.strip() for m in args.quant_modes.split(",") if m.strip()]
    from ..models.verify import parse_quant_mode

    if "quant" in steps:
        # validate BEFORE the expensive legs: a typo'd mode must not throw
        # away a finished manifest/parity/smoke run
        for m in quant_modes:
            parse_quant_mode(m)
    out_dir = args.output or f"verify_{args.model.replace('/', '_')}"
    os.makedirs(out_dir, exist_ok=True)

    from ..models.config import REGISTRY as CONFIG_REGISTRY
    from ..models.config import get_config, torch_dtype
    from ..models.registry import GLOBAL_REGISTRY, _config_for_dir, _default_download, build_config, hub_files
    from ..models.verify import manifest_report, parity_report, tma_smoke

    # --- resolve the checkpoint dir and config -------------------------------
    if args.checkpoint is not None:
        ckpt_dir = args.checkpoint
        if args.model in CONFIG_REGISTRY:  # named configs incl. vla-tiny
            cfg = get_config(args.model)
        elif args.model in GLOBAL_REGISTRY:
            cfg = build_config(args.model)
        else:
            cfg = _config_for_dir(ckpt_dir)
    else:
        repo, patterns = hub_files(args.model)
        print(f"fetching {repo} ...", flush=True)
        ckpt_dir = _default_download(repo, patterns, args.cache_dir, args.hf_token)
        cfg = build_config(args.model)
    print(f"checkpoint: {ckpt_dir}\nconfig: {cfg.name}\ndevice: {dev}")
    if "quant" in steps:
        # bound-check vt<k> against THIS model's patch count, still before
        # any expensive leg
        for m in quant_modes:
            _, _, vt, _ = parse_quant_mode(m)
            if vt is not None and vt > cfg.num_patches:
                build_parser().error(
                    f"--quant-modes {m!r}: vt{vt} exceeds the model's "
                    f"{cfg.num_patches} patch tokens"
                )
        from ..models.quant import int4_group_size_for

        # a --quant-tp the model cannot split fails here, not after the legs
        int4_group_size_for(cfg, tp=args.quant_tp)

    # prismatic zoo checkpoints are a torch .pt (no safetensors headers):
    # load + rename upfront, validate the manifest over the in-memory state
    is_prismatic = os.path.exists(os.path.join(ckpt_dir, "checkpoints", "latest-checkpoint.pt"))
    report = {"model": args.model, "checkpoint": ckpt_dir, "device": str(dev), "steps": {},
              "layout": "prismatic-pt" if is_prismatic else "safetensors"}
    ok = True

    def nbytes(tensors):
        return sum(v.numel() * v.element_size() for v in tensors)

    state = params = None
    if is_prismatic:
        from ..models.registry import read_prismatic_state_dict

        t0 = time.time()
        state = read_prismatic_state_dict(ckpt_dir)
        print(f"loaded prismatic .pt state in {time.time()-t0:.1f}s "
              f"({nbytes(state.values())/1e9:.2f} GB)")

    # --- 1. manifest ---------------------------------------------------------
    if "manifest" in steps:
        from ..models.verify import manifest_report_from_state

        t0 = time.time()
        m = manifest_report_from_state(state, cfg) if is_prismatic else manifest_report(ckpt_dir, cfg)
        report["steps"]["manifest"] = m.to_json()
        status = "PASS" if m.ok else "FAIL"
        print(f"[manifest] {status} in {time.time()-t0:.1f}s — {m.n_tensors} tensors, "
              f"{m.total_bytes/1e9:.2f} GB, dtypes {m.dtypes}")
        for miss in m.missing[:20]:
            print(f"  MISSING: {miss}")
        for bad in m.shape_mismatches[:20]:
            print(f"  SHAPE:   {bad}")
        suppressed = max(0, len(m.missing) - 20) + max(0, len(m.shape_mismatches) - 20)
        if suppressed:
            print(f"  ... and {suppressed} more")
        ok &= m.ok
        if not m.ok:
            # the expensive legs would only fail more confusingly
            steps = [s for s in steps if s == "manifest"]
            print("[manifest] failing fast: skipping parity/smoke/quant")

    if any(s in steps for s in ("parity", "smoke", "quant")):
        from ..models.convert import convert_state_dict
        from ..models.safetensors_io import read_state_dict

        t0 = time.time()
        if state is None:
            state = read_state_dict(ckpt_dir)
        # converted on the host: parity makes its own fp32 copy on the device,
        # and the smoke and quant legs take the model-dtype copy after it
        params = convert_state_dict(state, cfg, "cpu")
        print(f"loaded + converted state dict in {time.time()-t0:.1f}s "
              f"({nbytes(state.values())/1e9:.2f} GB)")

    # --- 2. parity -----------------------------------------------------------
    if "parity" in steps:
        t0 = time.time()
        pr = parity_report(
            state, cfg, params=params, modules=modules,
            batch=args.parity_batch, seq=args.parity_seq, seed=args.seed,
            rel_tol=args.parity_rel_tol, device=dev,
        )
        report["steps"]["parity"] = pr
        for name, d in pr.items():
            status = "PASS" if d["ok"] else "FAIL"
            print(f"[parity:{name}] {status} max_rel={d['max_rel']:.2e} "
                  f"max_abs={d['max_abs']:.2e} ref_scale={d['ref_scale']:.2e}")
            ok &= d["ok"]
        print(f"[parity] done in {time.time()-t0:.1f}s")

    n_params = sum(v.numel() for v in state.values()) if state is not None else 0
    if dev.type == "cpu" and n_params > 1_000_000_000:
        # 20 forward + backward passes of a 7B on the host CPU take days,
        # and each quant mode is n_batches 7B decodes: both legs belong on
        # the card
        for leg in ("smoke", "quant"):
            if leg in steps:
                print(f"[{leg}] SKIPPED: {n_params/1e9:.1f}B params on the CPU; run "
                      f"`--steps {leg} --device cuda` on the card")
                report["steps"][leg] = {"skipped": "cpu device, model too large"}
        steps = [s for s in steps if s not in ("smoke", "quant")]

    dev_params = None
    if "smoke" in steps or "quant" in steps:
        from ..models.verify import tree_to

        dev_params = tree_to(params, dev, torch_dtype(cfg))
    params = state = None

    # --- 3. smoke ------------------------------------------------------------
    if "smoke" in steps:
        t0 = time.time()
        sm = tma_smoke(dev_params, cfg, iters=args.smoke_iters, batch_size=args.smoke_bs,
                       lr=args.smoke_lr, seed=args.seed)
        status = "PASS" if sm["decreased"] else "FAIL"
        print(f"[smoke] {status} in {time.time()-t0:.1f}s — loss "
              f"{sm['losses'][0]:.4f} -> {sm['losses'][-1]:.4f} over "
              f"{len(sm['losses'])} TMA iters")
        from ..attacks.artifacts import save_checkpoint

        save_checkpoint(out_dir, "smoke", sm["patch"])
        report["steps"]["smoke"] = {
            "losses": sm["losses"], "decreased": sm["decreased"],
            "patch_artifact": os.path.join(out_dir, "smoke", "patch.pt"),
        }
        ok &= sm["decreased"]

    # --- 4. quantized-serving agreement ---------------------------------------
    if "quant" in steps:
        from ..models.verify import quant_decode_report

        t0 = time.time()
        qr = quant_decode_report(dev_params, cfg, modes=quant_modes, seed=args.seed,
                                 min_agreement=args.quant_min_agreement, tp=args.quant_tp)
        report["steps"]["quant"] = qr
        for mode, d in qr.items():
            tag = ("PASS" if d["ok"] else "FAIL") if "ok" in d else "info"
            print(f"[quant:{mode}] {tag} token_agreement={d['token_agreement']:.4f} "
                  f"first_token={d['first_token_agreement']:.4f} "
                  f"max|dA|={d['max_abs_action_delta']:.4g}")
            ok &= d.get("ok", True)
        print(f"[quant] done in {time.time()-t0:.1f}s")
    del dev_params

    report["ok"] = bool(ok)
    with open(os.path.join(out_dir, "verify_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"{'ACCEPTED' if ok else 'REJECTED'} — report at "
          f"{os.path.join(out_dir, 'verify_report.json')}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
