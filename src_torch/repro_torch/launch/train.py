"""Training launcher (port of ``repro/launch/train.py``).

Builds the model from ``--arch``, a synthetic data pipeline, the train
step and checkpointing, and trains on ``--device`` (default: the CUDA
card; ``cpu`` only when named).  The initial parameters come from
``--seed`` through the port's own initializer (the reference draws them
from ``jax.random``), so the two launchers' runs are not compared.

Example:
  PYTHONPATH=src_torch python -m repro_torch.launch.train \\
      --arch flower-quickstart --steps 200 --batch 8 --seq 256
  PYTHONPATH=src_torch python -m repro_torch.launch.train --smoke \\
      --steps 20 --device cpu --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.config import TrainConfig, get_model_config
from repro_torch.data.loader import FederatedDataLoader
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train.steps import make_train_state, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="flower-quickstart")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_model_config(args.arch, smoke=args.smoke)
    if args.d_model:
        cfg = cfg.replace(d_model=args.d_model,
                          head_dim=args.d_model // cfg.num_heads)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    model = build_model(cfg)
    print(f"arch={cfg.name} params={model.param_count()/1e6:.1f}M")

    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq,
                       learning_rate=args.lr, warmup_steps=args.steps // 10,
                       total_steps=args.steps, seed=args.seed)
    state = make_train_state(model, tcfg, args.seed, device=dev)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start = restore_checkpoint(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    step_fn = make_train_step(model, tcfg, device=dev)
    loader = FederatedDataLoader(cfg.vocab_size, args.seq, num_sites=1,
                                 batch_per_site=args.batch, seed=args.seed)
    t0 = time.perf_counter()
    tokens_done = 0
    metrics = None
    for step in range(start, args.steps):
        batch = loader.next_batch(0)
        state, metrics = step_fn(state, batch)
        tokens_done += args.batch * args.seq
        if (step + 1) % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(f"step {step+1:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"tok/s {tokens_done/dt:,.0f}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, state)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, state)
    # a run resumed at its last step trains no step and has no loss
    print("done:", float(metrics["loss"]) if metrics is not None else None)


if __name__ == "__main__":
    main()
