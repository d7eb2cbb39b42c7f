"""The Trainer layer (port of ``repro.rl.trainer.base``, one device):
one loop, one checkpoint flow, one RNG convention.

``Trainer.train`` owns the loop: the family's stages in turn (one
unnamed stage, or two-stage HRL's "action" then "subgoal"), ``iters``
iterations each, at global step ``g = stage_index * iters + it``.
Each iteration the learner packs its weights and pushes them through
:class:`FleetSync`; the fleet fetches at the trainer's ``fetch_lag``
and the per-slot staleness gives the ``alive`` mask.  The iteration's
draws come from a generator seeded from (seed, g)
(``train_steps.iteration_generator``), so a resumed run draws exactly
the stream the uninterrupted run would.  Checkpoints are written at
step g and store the ``TrainState`` under the reference's index keys
with the family's metadata (the stage and the iteration within it) and
the ``schema`` tag; the metadata is validated before the tree is
restored, and a resume lands inside the recorded stage.

Telemetry (``--metrics-dir``) and the profiler (``--profile-dir``)
arrive with the observability slice.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.obs import Console
from repro_torch.rl.actor_learner import FleetSync, sync_bytes
from repro_torch.rl.inference import not_in_slice
from repro_torch.rl.train_steps import iteration_generator
from repro_torch.rl.trainer.state import (STATE_SCHEMA, TrainState,
                                          as_checkpoint_tree)


def resolve_mesh(mesh_kind: str, mesh_devices: Optional[int], n_envs: int,
                 verbose: bool = False) -> int:
    """The number of actor slots: one device, so one slot.  The sharded
    fleet over several cards arrives with the sharded slice."""
    if mesh_kind not in ("host", "production"):
        raise ValueError(f"unknown mesh kind {mesh_kind!r} "
                         "(expected 'host' or 'production')")
    if mesh_kind == "production" or (mesh_devices or 1) > 1:
        raise not_in_slice(f"--mesh {mesh_kind} --mesh-devices "
                           f"{mesh_devices}", "sharded")
    Console(verbose).info(f"one device: 1 actor slot(s) x {n_envs} envs")
    return 1


def flag_mismatch(ckpt_dir, flag: str, saved, have, reason: str = "",
                  verb: str = "saved by") -> ValueError:
    """The one checkpoint-vs-flags error format (metadata is validated
    before the tree restore, so a mismatched template fails with this
    and never a missing-leaf KeyError)."""
    why = f"{reason}; " if reason else ""
    return ValueError(
        f"checkpoint in {ckpt_dir} was {verb} --{flag} {saved}, not "
        f"{have} — {why}relaunch with the original flags")


class Trainer:
    """Base driver: subclasses supply the family seams, this class owns
    the loop, the checkpoint flow and the weight sync."""

    family = "?"

    def __init__(self, *, iters: int, seed: int, ckpt_dir: Optional[str],
                 save_every: int, log_every: int, verbose: bool,
                 device: torch.device, n_slots: int = 1, max_lag: int = 1,
                 fetch_lag: int = 0):
        self.iters = iters
        self.seed = seed
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.log_every = log_every
        self.verbose = verbose
        self.console = Console(verbose)
        self.device = device
        self.n_slots = n_slots
        self.max_lag = max_lag
        self.fetch_lag = fetch_lag
        self.stage_list = [None]
        self.stage_names = ["all"]

    # ---- family seams ----------------------------------------------------
    def init_state(self) -> TrainState:
        raise NotImplementedError

    def build_iteration(self):
        raise NotImplementedError

    def step(self, iteration, state, packed, gen, g: int, stage_ctx, alive):
        """Run one iteration; returns ``(state, ret, n_ep)``."""
        raise NotImplementedError

    def pack(self, state):
        """The packed (int8) weight payload the fleet syncs."""
        raise NotImplementedError

    def stage_setup(self, state, stage):
        """What ``step`` gets as ``stage_ctx`` during ``stage``."""
        return None

    def validate_metadata(self, md: dict) -> None:
        pass

    def metadata(self, it: int, stage) -> dict:
        return {}

    def resume_start(self, md: dict) -> int:
        raise NotImplementedError

    def resume_message(self, md: dict, state, start: int) -> str:
        return f"resumed at iter {start}"

    def log_line(self, it, ret, n_ep, metrics: dict, stage) -> str:
        raise NotImplementedError

    def export_state(self, state, state_out: Optional[dict]) -> None:
        pass

    # ---- the one driver --------------------------------------------------
    def restore(self, mgr: CheckpointManager, state: TrainState):
        """Flags are validated against the sidecar first; the tree then
        restores into the state's own template."""
        md = mgr.metadata()
        schema = md.get("schema")
        if schema != STATE_SCHEMA:
            raise ValueError(
                f"checkpoint in {self.ckpt_dir} records state schema "
                f"{schema!r}, but this launcher reads {STATE_SCHEMA!r}")
        self.validate_metadata(md)
        tree, md = mgr.restore(as_checkpoint_tree(state))
        return TrainState(*tree), md

    def train(self, state_out: Optional[dict] = None):
        con = self.console
        state = self.init_state()
        start, mgr = 0, None
        if self.ckpt_dir:
            mgr = CheckpointManager(self.ckpt_dir, keep=2,
                                    save_every=self.save_every)
            if mgr.latest_step() is not None:
                state, md = self.restore(mgr, state)
                start = self.resume_start(md)
                con.info(self.resume_message(md, state, start))
        iteration = self.build_iteration()
        sync = FleetSync(self.n_slots, max_lag=self.max_lag)
        history = []
        total_payload = w_payload = w_fp32 = 0
        t0 = time.time()
        for si, stage in enumerate(self.stage_list):
            ctx = self.stage_setup(state, stage)
            for it in range(self.iters):
                g = si * self.iters + it  # global step: stages never
                if g < start:             # collide, and a resume lands
                    continue              # inside its stage
                sync.push(self.pack(state))
                stale = sync.fetch(self.fetch_lag)
                payload, fp32_eq = sync_bytes(stale)
                total_payload += payload
                w_payload += payload
                w_fp32 += fp32_eq
                # seeded from the global step, not a running stream: a
                # resumed run at step g draws what the uninterrupted one
                # would have
                gen = iteration_generator(self.seed, g, self.device)
                state, ret, n_ep = self.step(iteration, state, stale, gen,
                                             g, ctx, sync.alive())
                # the loop's one host read an iteration
                ret_f = float(ret)
                history.append(ret_f)
                if it % self.log_every == 0 or it == self.iters - 1:
                    metrics = {"sync_payload_bytes": w_payload,
                               "sync_fp32_bytes": w_fp32,
                               "staleness_max": int(sync.staleness().max()),
                               "alive_frac": float(
                                   sync.alive().to(torch.float32).mean())}
                    con.info(self.log_line(it, ret_f, int(n_ep), metrics,
                                           stage))
                    w_payload = w_fp32 = 0
                if mgr and mgr.should_save(g):
                    mgr.save(g, as_checkpoint_tree(state),
                             metadata={**self.metadata(it, stage),
                                       "schema": STATE_SCHEMA})
        con.info(f"done in {time.time() - t0:.0f}s; "
                 f"total sync payload {total_payload / 2**20:.1f} MiB")
        self.export_state(state, state_out)
        return state, history
