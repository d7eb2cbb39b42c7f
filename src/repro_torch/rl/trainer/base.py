"""The Trainer layer (port of ``repro.rl.trainer.base``): one loop, one
checkpoint flow, one RNG convention.

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

On a mesh (``--mesh host``) every rank of the mesh runs this loop in
lockstep over the same global steps and draws; rank 0 alone prints,
writes telemetry and profiles, and writes checkpoints (the family
gathers what is sharded first, every rank taking part).  A rank the
mesh leaves out (the default host mesh auto-fits its size to
``n_envs``) takes no part and returns at once.  ``barrier`` (the value
family's ``--sync lockstep`` on a mesh) fences the card and the mesh
after every step.

Telemetry (``metrics_dir``): after each step the iteration's ``record``
(``train_steps``) writes the step's metrics into the family's buffer on
the device, which is flushed, one host read, at each log window into an ``obs/v1`` ``step`` record of
``<metrics_dir>/train.jsonl`` with the host's own metrics (the sync
payload, staleness, ``steps_per_s``) and the window's ``sync``/``step``/
``checkpoint`` spans.  The sink opens after the restore, so a resumed
run's first window starts at the resume step.  The profiler
(``profile_dir``) traces ``profile_steps`` global steps from
``profile_start`` and writes a ``profile`` record when the trace closes.
Neither changes what the iteration computes.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import data_axis_size, fence
from repro_torch.launch.mesh import (describe, in_mesh, make_host_mesh,
                                     make_production_mesh, rank, world_size)
from repro_torch.obs import (Console, MetricSpec, ProfileWindow,
                             RunTelemetry, SpanClock, flush)
from repro_torch.rl.actor_learner import FleetSync, sync_bytes
from repro_torch.rl.train_steps import iteration_generator
from repro_torch.rl.trainer.state import (STATE_SCHEMA, TrainState,
                                          as_checkpoint_tree)


def build_mesh(mesh_kind: str = "host", mesh_devices: Optional[int] = None,
               device: DeviceLike = None):
    if mesh_kind == "production":
        if mesh_devices is not None:
            raise ValueError("--mesh-devices restricts the host mesh "
                             "only; the production mesh shape is fixed")
        return make_production_mesh(device=device)
    if mesh_kind == "host":
        return make_host_mesh(mesh_devices, device=device)
    raise ValueError(f"unknown mesh kind {mesh_kind!r} "
                     "(expected 'host' or 'production')")


def resolve_mesh(mesh_kind: str, mesh_devices: Optional[int], n_envs: int,
                 verbose: bool = False, device: DeviceLike = None):
    """The mesh and its slot count, with the env-divisibility contract
    of both families: the default host mesh fits its size to the largest
    rank count dividing ``n_envs`` (the ranks past it take no part); an
    explicit ``--mesh-devices`` that does not divide is an error.  The
    banner prints on rank 0."""
    if mesh_kind == "host" and mesh_devices is None:
        mesh_devices = world_size(device)
        while mesh_devices > 1 and n_envs % mesh_devices != 0:
            mesh_devices -= 1
    mesh = build_mesh(mesh_kind, mesh_devices, device)
    n_slots = data_axis_size(mesh)
    if n_envs % n_slots != 0:
        raise ValueError(f"--n-envs {n_envs} must be divisible by the "
                         f"mesh's {n_slots} data slot(s)")
    Console(verbose and rank() == 0).info(
        f"{describe(mesh)}: {n_slots} actor slot(s) x {n_envs // n_slots} "
        "envs")
    return mesh, n_slots


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
                 device: torch.device, mesh=None, n_slots: int = 1,
                 max_lag: int = 1, fetch_lag: int = 0, barrier: bool = False,
                 metrics_dir: Optional[str] = None,
                 profile_dir: Optional[str] = None, profile_start: int = 0,
                 profile_steps: int = 1):
        self.iters = iters
        self.seed = seed
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.log_every = log_every
        # rank 0 alone prints, writes telemetry and checkpoints
        self.lead = rank() == 0
        self.verbose = verbose
        self.console = Console(verbose and self.lead)
        self.device = device
        self.mesh = mesh
        self.n_slots = n_slots
        self.max_lag = max_lag
        self.fetch_lag = fetch_lag
        self.barrier = barrier
        self.metrics_dir = metrics_dir
        self.profile_dir = profile_dir
        self.profile_start = profile_start
        self.profile_steps = profile_steps
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

    def record(self, iteration, mbuf, state, ret, n_ep, g: int, alive):
        """Step ``g``'s metric writes into ``mbuf`` (the iteration's
        ``record`` on what the step returned); returns the buffer."""
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

    def metric_spec(self) -> Optional[MetricSpec]:
        """The family's metric buffer shape (None: no buffer even with
        telemetry on)."""
        return None

    def run_meta(self) -> dict:
        """The ``meta`` record's ``run`` block."""
        return {"family": self.family, "seed": self.seed,
                "iters": self.iters, "n_slots": self.n_slots}

    def host_metrics(self, metrics: dict, g: int) -> dict:
        """Host-side metrics merged into the record of the window ending
        at global step ``g`` (what the buffer does not carry)."""
        return {}

    def log_line(self, it, ret, n_ep, metrics: dict, stage) -> str:
        raise NotImplementedError

    def export_state(self, state, state_out: Optional[dict]) -> None:
        pass

    def checkpoint_tree(self, state: TrainState) -> tuple:
        """The tree a checkpoint stores (every rank calls it: a family
        whose state is sharded gathers it here)."""
        return as_checkpoint_tree(state)

    def state_from_checkpoint(self, tree) -> TrainState:
        """The state from a restored checkpoint tree (a sharded family
        takes its slot)."""
        return TrainState(*tree)

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
        return self.state_from_checkpoint(tree), md

    def train(self, state_out: Optional[dict] = None):
        """Run every stage: (final state, history of returns).  A rank
        outside the mesh returns (None, [])."""
        if self.mesh is not None and not in_mesh(self.mesh):
            return None, []
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
        tel = spec = None
        if self.metrics_dir:
            # telemetry opens after the restore, so the first window
            # starts at the resume step; the sink appends.  Every rank
            # keeps the buffer (its writes may gather over the mesh)
            spec = self.metric_spec()
            if self.lead:
                tel = RunTelemetry(self.metrics_dir, run=self.run_meta(),
                                   start=start)
        prof = (ProfileWindow(self.profile_dir, self.profile_start,
                              self.profile_steps, self.device)
                if self.profile_dir and self.lead else None)
        clock = tel.clock if tel else SpanClock()
        iteration = self.build_iteration()
        mbuf = spec.init(self.device) if spec else None
        sync = FleetSync(self.n_slots, max_lag=self.max_lag)
        history = []
        total_payload = w_payload = w_fp32 = 0
        t0 = time.time()
        t_win = time.perf_counter()
        for si, stage in enumerate(self.stage_list):
            ctx = self.stage_setup(state, stage)
            for it in range(self.iters):
                g = si * self.iters + it  # global step: stages never
                if g < start:             # collide, and a resume lands
                    continue              # inside its stage
                if prof:
                    self._profile_closed(prof, prof.tick(g), tel)
                with clock("sync"):
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
                alive = sync.alive()
                with clock("step"):
                    state, ret, n_ep = self.step(iteration, state, stale,
                                                 gen, g, ctx, alive)
                    if mbuf is not None:
                        mbuf = self.record(iteration, mbuf, state, ret,
                                           n_ep, g, alive)
                    if self.barrier:
                        # lockstep: fence the card and the mesh, so the
                        # next collect cannot overlap this update
                        fence(self.mesh, self.device)
                    # the loop's one host read an iteration, which ends
                    # the step's work on the card
                    ret_f = float(ret)
                history.append(ret_f)
                if it % self.log_every == 0 or it == self.iters - 1:
                    metrics, hists = {}, None
                    if mbuf is not None:
                        metrics, hists, mbuf = flush(spec, mbuf)
                    metrics.update(self.host_metrics(metrics, g))
                    metrics["sync_payload_bytes"] = w_payload
                    metrics["sync_fp32_bytes"] = w_fp32
                    metrics["staleness_max"] = int(sync.staleness().max())
                    metrics.setdefault("alive_frac", float(
                        alive.to(torch.float32).mean()))
                    wall = time.perf_counter() - t_win
                    if "env_steps" in metrics and wall > 0:
                        metrics["steps_per_s"] = round(
                            metrics["env_steps"] / wall, 2)
                    if tel:
                        tel.step_flush(g, metrics, hists)
                    con.info(self.log_line(it, ret_f, int(n_ep), metrics,
                                           stage))
                    w_payload = w_fp32 = 0
                    t_win = time.perf_counter()
                if mgr and mgr.should_save(g):
                    with clock("checkpoint"):
                        tree = self.checkpoint_tree(state)
                        if self.lead:
                            mgr.save(g, tree,
                                     metadata={**self.metadata(it, stage),
                                               "schema": STATE_SCHEMA})
                        if self.mesh is not None:
                            # no rank reads the directory before the
                            # write is whole
                            fence(self.mesh, self.device)
        if prof:
            self._profile_closed(prof, prof.stop(), tel)
        if tel:
            tel.close()
        con.info(f"done in {time.time() - t0:.0f}s; "
                 f"total sync payload {total_payload / 2**20:.1f} MiB")
        self.export_state(state, state_out)
        return state, history

    def _profile_closed(self, prof: ProfileWindow, win, tel) -> None:
        """Report a trace that just closed (``win`` None: none did)."""
        if not win:
            return
        if tel:
            tel.profile(prof.dir, win)
        self.console.info(f"profiler trace for steps [{win[0]}, {win[1]}] "
                          f"-> {prof.trace_path}")
