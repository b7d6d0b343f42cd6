"""The PyTorch port's twin of examples/train_lm.py: train a small LM with
the port's production substrate (deterministic data pipeline, AdamW,
checkpoint/restart with an injected failure), on the CUDA device.

Run: PYTHONPATH=src python examples/train_lm_torch.py [--steps 30]
"""
import argparse
import shutil
import tempfile

from repro_torch.data import lm_token_batches
from repro_torch.models.transformer import (LMConfig, lm_init_params,
                                            lm_train_forward)
from repro_torch.optim import AdamWConfig, init_opt_state, make_train_step
from repro_torch.runtime import FailureInjector, run_with_restarts

CFG = LMConfig(name="lm-demo", n_layers=4, d_model=128, n_heads=8,
               n_kv_heads=4, d_head=16, d_ff=512, vocab=512,
               tie_embeddings=True, seq_chunk=64, q_chunk=64, kv_chunk=64)


def main(argv=None, device=None):
    """Train, survive one injected failure, and return the per-step
    losses. Runs on ``cuda`` unless ``device`` names another device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)

    params = lm_init_params(CFG, seed=0, device=device)
    opt = init_opt_state(params)
    step = make_train_step(
        lambda p, b: lm_train_forward(p, CFG, b),
        AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=args.steps))
    batches = list(lm_token_batches(0, args.batch, args.seq, CFG.vocab,
                                    n_steps=args.steps, device=device))
    losses = []

    def step_fn(state, i):
        loss, p, o = step(state["params"], state["opt"], batches[i])
        losses.append(float(loss))
        if i % 5 == 0:
            print(f"step {i:4d} loss {float(loss):.4f}")
        return {"params": p, "opt": o}

    ckpt_dir = tempfile.mkdtemp(prefix="lm_ckpt_")
    try:
        # inject a failure mid-run: the loop resumes from the checkpoint and
        # replays the identical stream (deterministic pipeline)
        run_with_restarts(
            step_fn, {"params": params, "opt": opt}, args.steps, ckpt_dir,
            ckpt_every=10,
            injector=FailureInjector(fail_at=[args.steps // 2]))
        print(f"\nfirst loss {losses[0]:.4f} -> last {losses[-1]:.4f} "
              f"(survived 1 injected failure, ckpts in {ckpt_dir})")
        if not losses[-1] < losses[0]:
            raise RuntimeError("the loss did not decrease")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return losses


if __name__ == "__main__":
    main()
