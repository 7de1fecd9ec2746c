"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 8 --batch 4 --seq 1024 --remat full        # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
      [--ckpt-dir /tmp/ck] [--fail-at 20] [--compress-grads]

Same CLI as ``repro.launch.train`` plus ``--device`` (default ``cuda``,
which raises without a GPU). Weights are random, drawn from ``--seed``;
data is ``SyntheticTokens`` from the same seed, identical to the JAX
package's batches. The plain loop ends by asserting that the loss
decreased.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from repro_torch.configs.registry import get_config
from repro_torch.distributed.sharding import ADAFACTOR_ARCHS
from repro_torch.models.factory import build_model
from repro_torch.training import grad_compression as gc
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import DataConfig, SyntheticTokens
from repro_torch.training.fault_tolerance import (FailureInjector,
                                                  ResilientTrainer)
from repro_torch.training.optimizer import OptimizerConfig, make_optimizer
from repro_torch.training.train_step import loss_and_grads, make_train_step


@dataclass
class TrainRun:
    """What the plain loop measured: the loss of every step and each
    step's host time (the loss is read back every step, so it includes
    the device's work)."""
    losses: list[float]
    step_seconds: list[float]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default=None,
                    choices=[None, "adamw", "adafactor"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, action="append", default=[])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_name = args.optimizer or (
        "adafactor" if cfg.name.replace("-reduced", "") in ADAFACTOR_ARCHS
        else "adamw")
    model = build_model(cfg, device=args.device)
    opt_cfg = OptimizerConfig(name=opt_name, lr=args.lr, warmup_steps=10)
    init_state, train_step = make_train_step(model, opt_cfg, remat=args.remat)

    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))

    if args.compress_grads:
        _, opt_update = make_optimizer(opt_cfg)

        def train_step(params, opt_state, batch):  # noqa: F811
            # compress -> decompress round trip of the gradients (no
            # error feedback carried across steps, as in the JAX launcher)
            loss, grads = loss_and_grads(model, params, batch,
                                         remat=args.remat)
            grads = gc.decompress(gc.compress(grads)[0])
            new_params, new_opt, om = opt_update(grads, opt_state, params)
            return new_params, new_opt, {"loss": loss, **om}

    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params, opt_state = init_state(gen, torch.float32)

    def step_fn(state, batch):
        params, opt_state = state
        params, opt_state, metrics = train_step(params, opt_state, batch)
        return (params, opt_state), metrics

    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=2, device=model.device)
        injector = (FailureInjector(tuple(args.fail_at)) if args.fail_at
                    else None)
        trainer = ResilientTrainer(step_fn, data.batch, ckpt,
                                   ckpt_every=args.ckpt_every,
                                   injector=injector)
        (params, opt_state), result = trainer.run((params, opt_state),
                                                  args.steps)
        print(f"[train] done step={result.final_step} "
              f"restarts={result.restarts} "
              f"loss[0]={result.losses[0]:.4f} "
              f"loss[-1]={result.losses[-1]:.4f}")
        return result
    # plain loop
    t0 = time.monotonic()
    losses, seconds = [], []
    for step in range(args.steps):
        t_step = time.monotonic()
        (params, opt_state), metrics = step_fn((params, opt_state),
                                               data.batch(step))
        losses.append(float(metrics["loss"]))
        seconds.append(time.monotonic() - t_step)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step={step} loss={losses[-1]:.4f} "
                  f"({time.monotonic() - t0:.1f}s)", flush=True)
    assert losses[-1] < losses[0], "loss did not decrease"
    print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} OK")
    return TrainRun(losses, seconds)


if __name__ == "__main__":
    main()
