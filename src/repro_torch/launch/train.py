"""Restartable LM training loop (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 50 [--policy w8a8] [--ckpt-dir /tmp/ck] [--device cpu]

Every family of ``configs.registry`` trains through its ``loss_fn``:
the forward's products quantized (on the card, Q-MAC's int32 kernel;
the MoE experts' through its batched fused kernel), the backward the
straight-through estimator, then AdamW under a warmup-cosine schedule.
The loop is restart-safe: it resumes from the newest checkpoint in
``ckpt_dir`` (the reference's npz + JSON layout, so either package
resumes the other's), saves every ``save_every`` steps and at the end,
and its batches are a pure function of the step, so a run stopped and
resumed ends bit for bit where an uninterrupted one does.  A checkpoint
is named by the number of steps it holds (``step_4`` after steps 0-3).
The reference names its final checkpoint so, but a periodic one by the
index of the step just taken, so a resume from it takes that step a
second time; the port names both by the steps taken.

As in the reference, ``--smoke`` is ``store_true`` with a default of
True, so the CLI always trains the reduced config; the published widths
are reached through ``train(arch, smoke=False)``.  Runs on the card
unless ``device="cpu"`` / ``--device cpu`` is given.

The loop always runs on the host mesh (``launch.mesh.make_host_mesh``),
as the reference's does: one rank without ``torchrun``, N under
``torchrun --nproc-per-node N`` (NCCL on the card, gloo on the CPU).
Every rank draws the same params from ``seed`` and keeps them
replicated; each step ``data.place`` lays out the batch, so a rank
holds its slot's rows, and ``launch.steps.make_train_step`` averages
the slots' losses and gradients.  Rank 0 alone prints and writes checkpoints;
every rank waits for each save, and every rank restores the newest
checkpoint on a resume.  At one rank the run is the unsharded run bit
for bit.  Like the reference, ``train("whisper-large-v3")`` raises
``KeyError: 'frames'``: the synthetic batches carry no audio frames.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_arch
from repro_torch.core.policy import get_policy
from repro_torch.data import DataConfig, batch_at, place
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import fence
from repro_torch.launch.mesh import describe, make_host_mesh, rank
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import model_for
from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine


def train(arch: str, steps: int = 50, smoke: bool = True,
          policy_name: Optional[str] = "w8a8", seq_len: int = 128,
          batch: int = 8, ckpt_dir: Optional[str] = None,
          save_every: int = 20, lr: float = 3e-4,
          log_every: int = 10, seed: int = 0,
          device: DeviceLike = None):
    """Train ``arch`` for ``steps`` steps from random weights drawn from
    ``seed`` (or from the newest checkpoint in ``ckpt_dir``); returns
    (params, the logged losses)."""
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    policy = get_policy(policy_name) if policy_name else None
    dev = resolve_device(device)
    mesh = make_host_mesh(device=dev)
    model = model_for(cfg)
    lead = rank() == 0
    log = print if lead else (lambda *a, **kw: None)
    log(f"training {cfg.name} on {describe(mesh)} policy={policy_name}")

    # init (or resume)
    params = model.init(torch.Generator().manual_seed(seed), cfg,
                        device=dev)
    opt_state = adamw_init(params)
    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3, save_every=save_every)
        if mgr.latest_step() is not None:
            (params, opt_state), start_step = mgr.restore(
                (params, opt_state))[0], mgr.latest_step()
            log(f"resumed from step {start_step}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                      global_batch=batch, seed=seed)
    sched = warmup_cosine(lr, max(steps // 10, 1), steps)
    step_fn = make_train_step(cfg, mesh, policy,
                              AdamWConfig(weight_decay=0.0),
                              schedule=sched)

    def save(step):
        # rank 0 writes; every rank waits for the file before going on
        if lead:
            mgr.save(step, (params, opt_state))
        fence(mesh, dev)

    t0 = time.time()
    tokens_per_batch = seq_len * batch
    losses = []
    for step in range(start_step, steps):
        data = place(batch_at(dcfg, step), mesh)
        params, opt_state, stats = step_fn(params, opt_state, data)
        if step % log_every == 0 or step == steps - 1:
            loss = float(stats["loss"])
            losses.append(loss)
            dt = time.time() - t0
            log(f"step {step:5d}  loss {loss:8.4f}  "
                f"gnorm {float(stats['grad_norm']):7.3f}  "
                f"{(step - start_step + 1) * tokens_per_batch / max(dt, 1e-9):8.0f} tok/s")
        # a checkpoint is named by the steps it holds, as the final one
        # is, so a resume from it takes the next step, not this one again
        if mgr and mgr.should_save(step + 1) and step + 1 < steps:
            save(step + 1)
    if mgr:
        save(steps)
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--policy", default="w8a8")
    ap.add_argument("--fp32", action="store_true",
                    help="disable quantization (baseline)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    train(args.arch, args.steps, args.smoke,
          None if args.fp32 else args.policy, args.seq_len, args.batch,
          args.ckpt_dir, args.save_every, args.lr, device=args.device)


if __name__ == "__main__":
    main()
