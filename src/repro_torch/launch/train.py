"""Train launcher (port of ``repro.launch.train``): ``--arch <id>``
resolves a registry configuration and trains its reduced (``SMOKE``) size
end to end: a dense or MoE LM, or, for a recsys arch (no ``SMOKE``),
``configs.recsys_family.smoke(name)``'s train step and serve call, as
JAX's launcher runs ``arch.smoke()``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 10 --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec

Exercised: the deterministic data pipeline, AdamW, checkpoint/restart
(resumes from the newest checkpoint in --ckpt-dir) and optional int8
error-feedback gradient compression. Runs on ``cuda`` unless ``main`` is
given another device.
"""
from __future__ import annotations

import argparse
from typing import Any, List, Optional

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import recsys_family
from repro_torch.configs.registry import config_module
from repro_torch.data.pipeline import lm_token_batches
from repro_torch.models.transformer import lm_init_params, lm_train_forward
from repro_torch.optim import (AdamWConfig, adamw_update, ef_compress_update,
                               init_compression_state, init_opt_state,
                               value_and_grad)
from repro_torch.runtime import run_with_restarts


def main(argv: Optional[List[str]] = None,
         device: DeviceLike = None) -> Any:
    """Parse ``argv`` (the command line when None), train, and return the
    final ``{"params", "opt"}`` state (a recsys arch: its smoke result)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args(argv)

    mod = config_module(args.arch)
    dev = resolve_device(device)
    if not hasattr(mod, "SMOKE"):
        # non-LM archs: their smoke train step and serve call
        out = recsys_family.smoke(args.arch, device=dev)
        print(f"{args.arch}: non-LM arch; smoke train step ran: {out}")
        return out
    cfg = mod.SMOKE
    print(f"training reduced {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab}")
    params = lm_init_params(cfg, seed=0, device=dev)
    opt = init_opt_state(params)
    cstate = init_compression_state(params) if args.grad_compression else None
    adam = AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps)
    batches = list(lm_token_batches(0, args.batch, args.seq, cfg.vocab,
                                    n_steps=args.steps, device=dev))

    def loss_fn(p, batch):
        return lm_train_forward(p, cfg, batch)

    def step_fn(state, i):
        nonlocal cstate
        loss, grads = value_and_grad(loss_fn, state["params"], batches[i])
        if cstate is not None:
            grads, cstate = ef_compress_update(grads, cstate)
        p, o = adamw_update(grads, state["opt"], state["params"], adam)
        print(f"step {i:4d} loss {float(loss):.4f}")
        return {"params": p, "opt": o}

    final = run_with_restarts(step_fn, {"params": params, "opt": opt},
                              args.steps, args.ckpt_dir,
                              ckpt_every=args.ckpt_every)
    print("done; final step:", int(final["opt"]["step"]))
    return final


if __name__ == "__main__":
    main()
