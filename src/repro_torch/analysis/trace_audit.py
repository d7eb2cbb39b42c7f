"""Mode 2 — one real iteration of every accepted training combo under an
op recorder (port of ``repro.analysis.trace_audit``).

PyTorch has no abstract evaluation the port's kernels can pass through
(they are ``ctypes`` launches, which a FakeTensor has no storage for),
so each (env x net x algo x precision) combination ``rl_train`` accepts
is built by the real trainers (:mod:`repro_torch.rl.trainer` — the
exact programs training runs) at the reference audit's small sizes
(4 envs, 2 collect steps — 8 for the on-policy family — a replay of
512, one update) and run for one iteration under a
``TorchDispatchMode`` that sees every PyTorch op, on the card unless
``device="cpu"``.  Audited:

* **QF901a** — no ``float64``/``complex128`` output of any op in the
  step.  The kernels' plain versions stand in for the kernels on the
  CPU (Q-MAC and Q-Conv compute the exact integer product in fp64
  there), so the recorder skips every op inside a kernel wrapper's call
  (``repro_torch.record``): the CPU and the card audit the same
  program.  int64 is PyTorch's index dtype (``gather``, ``argmax``,
  ``randint``) and is allowed inside the step; QF901b guards the state.
  On the card, every fxp8 combo must also have raised its kernel's
  launch counter (Q-MAC for mlp, Q-Conv for conv): the audited program
  is the card's, not the plain one.
* **QF901b** — every threaded-state leaf comes back with the shape,
  dtype and device it went in with (a drift is a silent upcast or a
  state that moves).  The reference also compares JAX's weak_type,
  which has no PyTorch counterpart.
* **QF902** — every packed ``QTensor``'s scale sits on its consumer's
  per-out-channel grid: 2-D ``[in, out]`` weights -> ``(1, out)``,
  stacked 3-D ``[L, in, out]`` -> ``(L, 1, out)``, conv HWIO 4-D ->
  ``(1, 1, 1, c_out)``.  Any *other* rank is itself a finding.
* **QF903** — every forward a real ``PolicyServer`` ran had a row count
  on its bucket ladder, every bucket was warmed by ``warmup()``, and no
  bucket ran for the first time after it (a cold bucket is a first-call
  cost — kernel build, allocator growth — inside a request latency).
* **QF904** — the state the reference donates and the port writes in
  place keeps its storage across the iteration (one live copy): every
  buffer-sized leaf of the replay (its columns and PER's sum tree; the
  0-dim pointer, size and max priority are rebound scalars).  The
  on-policy family writes no state in place (its optimizer and env
  states are rebound, as the reference's are donated and rewritten), so
  it holds none.

The same recorder, made with ``costing=True``, is the dry run's trace
(``launch.steps.lower_cell``, read by ``launch.hlo_analysis``): it keeps
one :class:`OpRecord` for every op, kernel call and collective, in
order, and the peak of the live bytes the recorded calls allocate.
"""
from __future__ import annotations

import contextlib
import dataclasses
import traceback
import weakref
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import record
from repro_torch.analysis.rules import Finding
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import leaves_with_path, path_str

CHECKS: Dict[str, str] = {
    "QF901": "float64/complex128 value in the step, threaded-state drift "
             "(shape/dtype/device) across one iteration, or an fxp8 "
             "combo that launched no kernel on the card",
    "QF902": "QTensor scale off the consumer's per-out-channel grid",
    "QF903": "a served forward off the bucket ladder, or a bucket first "
             "run after warmup()",
    "QF904": "state the port writes in place (the replay) left its "
             "storage during the iteration (a whole copy)",
}

PRECISION_AXIS = ("fp32", "fxp8")
_WIDE_DTYPES = (torch.float64, torch.complex128)
# the kernel counters an fxp8 combo's actors must raise on the card
_ACTOR_KERNELS = {"mlp": ("qmac_i8", "qmac_i8_deq"),
                  "conv": ("qconv_i8_taps",)}


@dataclasses.dataclass
class TraceResult:
    findings: List[Finding]
    combos_checked: List[str]
    # family -> the state leaves QF904 held in place
    held: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    # kernel name -> launches over the whole sweep
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# combo enumeration — by construction the same acceptance logic the
# CLI runs: the real constructors either build the combo or raise
# ---------------------------------------------------------------------------


def accepted_combos() -> List[Tuple[str, str, str, str]]:
    """Every (env, net, algo, precision) that ``rl_train``'s dispatch
    accepts, decided by calling the real env/agent constructors."""
    from repro_torch.rl.envs import make, registered
    from repro_torch.rl.inference import (NETS, ON_POLICY_ALGOS,
                                          VALUE_ALGOS, build_env,
                                          make_value_agent)
    from repro_torch.rl.trainer import make_agent

    combos = []
    for env_name in sorted(registered()):
        for net in NETS:
            for algo in ON_POLICY_ALGOS + VALUE_ALGOS:
                try:
                    if algo in ON_POLICY_ALGOS:
                        env = (build_env(env_name, net)
                               if net == "conv" else make(env_name))
                        make_agent("mlp", env,
                                   torch.Generator().manual_seed(0), net,
                                   device="cpu")
                    else:
                        env = build_env(env_name, net)
                        make_value_agent(algo, env.spec, net=net)
                except ValueError:
                    continue
                for precision in PRECISION_AXIS:
                    combos.append((env_name, net, algo, precision))
    return combos


def _combo_tag(env_name, net, algo, precision) -> str:
    return f"trace:{env_name}/{net}/{algo}/{precision}"


# ---------------------------------------------------------------------------
# QF901a — the op recorder
# ---------------------------------------------------------------------------


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _origin() -> str:
    """The innermost frame of the port (outside this package) on the
    stack: where a recorded value was made."""
    for fr in reversed(traceback.extract_stack()):
        path = fr.filename.replace("\\", "/")
        if "/repro_torch/" in path and "/repro_torch/analysis/" not in path:
            rel = path[path.rindex("/repro_torch/") + 1:]
            return f"src/{rel}:{fr.lineno} ({fr.name})"
    return "outside repro_torch"


class OpRecord(NamedTuple):
    """One recorded call: an op, a kernel wrapper's call or a
    collective, with the shapes and dtypes of its tensor operands and
    outputs and the elements each addresses (a broadcast dimension,
    stride 0, addresses one)."""

    kind: str             # "op", "kernel" or "collective"
    name: str             # "aten.mm", "qmac_i8", "all-gather", ...
    ins: Tuple            # ((shape, dtype, elements), ...) of the
    outs: Tuple           # tensor operands and of the outputs
    view: bool            # an op whose outputs alias an operand
    extra: Any            # a kernel's integer ops, a collective's peers,
    #                       convolution_backward's output mask


def _specs(ts) -> Tuple:
    return tuple((tuple(t.shape), t.dtype, _addressed(t)) for t in ts)


def _addressed(t: torch.Tensor) -> int:
    n = 1
    for size, stride in zip(t.shape, t.stride(), strict=True):
        if stride:
            n *= size
    return n if t.numel() else 0


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


_OP_NAMES: Dict[Any, Tuple[str, bool]] = {}


def _op_name(func) -> Tuple[str, bool]:
    """(``namespace.op``, whether it is a view op) of an op overload."""
    got = _OP_NAMES.get(func)
    if got is None:
        got = _OP_NAMES[func] = (str(func.overloadpacket),
                                 bool(getattr(func, "is_view", False)))
    return got


class OpRecorder(TorchDispatchMode):
    """Records every op's wide (float64/complex128) outputs with the port
    frame that produced them.  Ops inside a kernel wrapper's call (its
    launch, or its plain version on the CPU: ``with
    recorder.inside_kernel():``) are not the audited program: the call
    is one record (``kernel``), on every device.

    ``costing=True`` also keeps an :class:`OpRecord` for every call in
    ``records`` and tracks the bytes the calls allocate: a call's output
    whose storage is none of its operands' is a new allocation, live
    until the last recorded tensor on that storage dies (a
    ``weakref.finalize``; autograd keeps a tensor it saves alive);
    ``peak_bytes`` is the most that were live at once.  A costing
    recorder does not audit wide values."""

    def __init__(self, costing: bool = False):
        super().__init__()
        self.ops = 0
        self.wide: List[Tuple[str, str, str]] = []   # (dtype, op, origin)
        self._kernel_depth = 0
        self.costing = costing
        self.records: List[OpRecord] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, List[int]] = {}     # storage -> [refs, bytes]
        # (op, port frame) of the op that raised, if one did
        self.failed_op: Optional[Tuple[str, str]] = None

    @property
    def in_kernel(self) -> bool:
        return self._kernel_depth > 0

    @contextlib.contextmanager
    def inside_kernel(self):
        self._kernel_depth += 1
        try:
            yield
        finally:
            self._kernel_depth -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        try:
            out = func(*args, **(kwargs or {}))
        except Exception:
            if self.failed_op is None:
                self.failed_op = (str(func), _origin())
            raise
        if self._kernel_depth == 0:
            self.ops += 1
            outs = list(_tensors(out))
            for t in outs:
                if t.dtype in _WIDE_DTYPES and not self.costing:
                    self.wide.append((str(t.dtype).replace("torch.", ""),
                                      str(func), _origin()))
            if self.costing:
                name, view = _op_name(func)
                ins = list(_tensors(args)) + list(_tensors(kwargs or {}))
                extra = (tuple(args[10]) if name ==
                         "aten.convolution_backward" else None)
                self.records.append(OpRecord("op", name, _specs(ins),
                                             _specs(outs), view, extra))
                self._track(outs, ins)
        return out

    def kernel(self, name: str, args, out, int_ops: int) -> None:
        """A kernel wrapper's call (``repro_torch.record.kernel``)."""
        self.ops += 1
        if self.costing:
            ins, outs = list(_tensors(args)), list(_tensors(out))
            self.records.append(OpRecord("kernel", name, _specs(ins),
                                         _specs(outs), False, int_ops))
            self._track(outs, ins)

    def collective(self, kind: str, x: torch.Tensor, parts) -> None:
        """A gather over ``len(parts)`` peers
        (``distributed.sharding.gather_over``)."""
        self.ops += 1
        if self.costing:
            self.records.append(OpRecord("collective", kind, _specs([x]),
                                         _specs(parts), False, len(parts)))
            self._track(list(parts), [x])

    def _track(self, outs, ins) -> None:
        in_keys = {_storage_key(t) for t in ins}
        for t in outs:
            key = _storage_key(t)
            entry = self._live.get(key)
            if entry is None:
                if key in in_keys:
                    continue          # a view of a buffer made elsewhere
                nbytes = t.untyped_storage().nbytes()
                entry = self._live[key] = [0, nbytes]
                self.live_bytes += nbytes
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            entry[0] += 1
            weakref.finalize(t, self._release, key).atexit = False

    def _release(self, key: int) -> None:
        entry = self._live[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.live_bytes -= entry[1]
            del self._live[key]

    def wide_dtypes(self) -> List[str]:
        return sorted({d for d, _, _ in self.wide})


@contextlib.contextmanager
def recording(recorder: OpRecorder):
    """Run under ``recorder``, the kernel wrappers and collectives
    reporting to it (``repro_torch.record``): each wrapper's call is one
    kernel record, and the ops inside it (the card's launch, the CPU's
    plain version) are not recorded."""
    with record.activated(recorder), recorder:
        yield recorder


def wide_findings(recorder: OpRecorder, tag: str) -> List[Finding]:
    """One QF901 finding per wide dtype, naming where it first
    appeared."""
    out, seen = [], set()
    for dt, op, origin in recorder.wide:
        if dt in seen:
            continue
        seen.add(dt)
        out.append(Finding(
            tag, 0, "QF901",
            f"{dt} appears in the iteration ({op} at {origin}) — 64-bit "
            "values must not enter the quantized training step"))
    return out


# ---------------------------------------------------------------------------
# QF901b — threaded-state parity
# ---------------------------------------------------------------------------


def _sig(x) -> Tuple:
    return (tuple(x.shape), str(x.dtype).replace("torch.", ""),
            str(x.device))


def _leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    return [(path_str(p), t) for p, t in leaves_with_path(tree)
            if isinstance(t, torch.Tensor)]


def state_parity_mismatches(in_tree, out_tree, label: str) -> List[str]:
    """Leaves whose (shape, dtype, device) changed across the step."""
    ins, outs = _leaves(in_tree), _leaves(out_tree)
    if [p for p, _ in ins] != [p for p, _ in outs]:
        return [f"{label}: tree structure changed "
                f"({[p for p, _ in ins]} -> {[p for p, _ in outs]})"]
    bad = []
    for (path, i), (_, o) in zip(ins, outs, strict=True):
        si, so = _sig(i), _sig(o)
        if si != so:
            bad.append(f"{label}/{path}: {si} -> {so}")
    return bad


# ---------------------------------------------------------------------------
# QF902 — quantization grid audit
# ---------------------------------------------------------------------------


def expected_scale_shape(qvalue_shape: Tuple[int, ...]
                         ) -> Optional[Tuple[int, ...]]:
    """The per-out-channel grid the blessed consumers broadcast
    against; None = rank not in the convention table."""
    nd = len(qvalue_shape)
    if nd == 2:                       # [in, out] linear
        return (1, qvalue_shape[1])
    if nd == 3:                       # [L, in, out] stacked layers
        return (qvalue_shape[0], 1, qvalue_shape[2])
    if nd == 4:                       # [H, W, I, O] conv HWIO
        return (1, 1, 1, qvalue_shape[3])
    return None


def check_packed_tree(packed, bits: int, tag: str) -> List[Finding]:
    """Walk a packed tree and check every QTensor against the grid
    table."""
    from repro_torch.core.fxp import QTensor

    findings: List[Finding] = []

    def visit(node, path):
        if isinstance(node, QTensor):
            qshape = tuple(node.qvalue.shape)
            want = expected_scale_shape(qshape)
            got = tuple(node.scale.shape)
            if want is None:
                findings.append(Finding(
                    tag, 0, "QF902",
                    f"{path}: rank-{len(qshape)} QTensor {qshape} has "
                    "no entry in the per-out-channel grid table — "
                    "extend expected_scale_shape AND quantize_params "
                    "for the new layer family"))
            elif got != want:
                findings.append(Finding(
                    tag, 0, "QF902",
                    f"{path}: scale grid {got} != consumer grid "
                    f"{want} for weight {qshape} (w{bits})"))
            if node.bits != bits:
                findings.append(Finding(
                    tag, 0, "QF902",
                    f"{path}: packed bits {node.bits} != policy "
                    f"w_bits {bits}"))
            return
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, f"{path}/{k}")
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                visit(v, f"{path}[{i}]")

    visit(packed, "params")
    return findings


def audit_qtensor_grids(params, bits: int, tag: str) -> List[Finding]:
    """``quantize_params`` over ``params`` and check every produced
    QTensor against the grid table."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.quantizer import quantize_params

    policy = QuantPolicy(name=f"w{bits}", w_bits=bits, per_channel=True)
    with torch.no_grad():
        packed = quantize_params(params, policy)
    return check_packed_tree(packed, bits, tag)


# ---------------------------------------------------------------------------
# QF904 — storage held across the iteration
# ---------------------------------------------------------------------------


def held_leaves(state) -> Dict[str, int]:
    """``{path: storage pointer}`` of the leaves the port writes in
    place: every leaf of the replay with at least one axis."""
    if state.replay is None:
        return {}
    return {f"replay/{p}": t.untyped_storage().data_ptr()
            for p, t in _leaves(state.replay) if t.ndim >= 1}


def storage_mismatches(before: Dict[str, int], state) -> List[str]:
    """Held leaves whose storage changed across the step."""
    after = held_leaves(state)
    return [p for p, ptr in before.items() if after.get(p) != ptr]


# ---------------------------------------------------------------------------
# per-combo construction: the real trainers at the audit's sizes
# ---------------------------------------------------------------------------

_N_ENVS = 4
_ROLLOUT = 2
_ONPOLICY_ROLLOUT = 8   # 8 x 4 = 32 samples: the default 4 minibatches
_CAPACITY = 512


def build_trainer(env_name, net, algo, precision,
                  sharded_replay: Optional[str] = None,
                  device: DeviceLike = None):
    """The trainer ``rl_train`` would build for the combo, at the audit's
    sizes, on ``device``.  ``sharded_replay`` runs a value combo through
    the one-rank host mesh with that replay kind."""
    from repro_torch.rl.inference import ON_POLICY_ALGOS
    from repro_torch.rl.trainer import OnPolicyTrainer, ValueTrainer

    dev = resolve_device(device)
    pol = "fxp8" if precision == "fxp8" else None
    comm = 8 if pol else 32
    if algo in ON_POLICY_ALGOS:
        return OnPolicyTrainer(
            env_name, "mlp", iters=1, n_envs=_N_ENVS,
            rollout_len=_ONPOLICY_ROLLOUT, actor_policy=pol,
            comm_bits=comm, verbose=False, algo=algo, net=net,
            mesh_devices=1, device=dev)
    mesh = {} if sharded_replay is None else dict(
        mesh_kind="host", mesh_devices=1, sync="lockstep")
    return ValueTrainer(
        algo, env_name, iters=1, n_envs=_N_ENVS, rollout_len=_ROLLOUT,
        actor_policy=pol, comm_bits=comm, replay_capacity=_CAPACITY,
        updates_per_iter=1, per_beta0=0.4, per_beta_iters=1,
        verbose=False, net=net, replay=sharded_replay or "uniform",
        device=dev, **mesh)


def run_iteration(trainer, recorder: Optional[OpRecorder] = None):
    """One iteration of the trainer's loop from its initial state,
    under ``recorder`` when given: (state in, state out, the storage
    QF904 held before the step)."""
    from repro_torch.rl.actor_learner import FleetSync
    from repro_torch.rl.train_steps import iteration_generator

    state = trainer.init_state()
    iteration = trainer.build_iteration()
    sync = FleetSync(trainer.n_slots, max_lag=trainer.max_lag)
    sync.push(trainer.pack(state))
    packed = sync.fetch(trainer.fetch_lag)
    alive = sync.alive()
    ctx = trainer.stage_setup(state, trainer.stage_list[0])
    before = held_leaves(state)
    gen = iteration_generator(trainer.seed, 0, trainer.device)
    with (recording(recorder) if recorder is not None
          else contextlib.nullcontext()):
        out, _, _ = trainer.step(iteration, state, packed, gen, 0, ctx,
                                 alive)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    return state, out, before


# the sharded value path (per-rank collect + replay slots + slot-mean
# learner) must satisfy the same invariants as the single-device
# programs, at one rank
SHARDED_VALUE_COMBOS = (
    ("cartpole", "mlp", "dqn", "fp32", "uniform"),
    ("cartpole", "mlp", "dqn", "fxp8", "per"),
    ("cartpole", "mlp", "qrdqn", "fxp8", "uniform"),
    ("pendulum", "mlp", "ddpg", "fxp8", "uniform"),
    # pixel stem at fxp8: the integer Q-Conv path (an autograd Function
    # over the kernel) keeps the same discipline
    ("catch", "conv", "qrdqn", "fxp8", "uniform"),
)

_SLOTS = ("params", "target", "opt", "replay", "est", "obs")


# ---------------------------------------------------------------------------
# audits
# ---------------------------------------------------------------------------


def audit_step(env_name, net, algo, precision,
               sharded_replay: Optional[str] = None,
               device: DeviceLike = None,
               held: Optional[Dict[str, List[str]]] = None
               ) -> List[Finding]:
    """QF901-QF902 and QF904 on one combo's real iteration; ``held``
    (family -> leaves) collects what QF904 held."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    tag = _combo_tag(env_name, net, algo, precision)
    if sharded_replay is not None:
        tag += f"/sharded-{sharded_replay}"
    trainer = build_trainer(env_name, net, algo, precision,
                            sharded_replay, device)
    recorder = OpRecorder()
    reset_launch_counts()
    state, out, before = run_iteration(trainer, recorder)
    launches = launch_counts()

    findings = wide_findings(recorder, tag)
    if precision == "fxp8" and trainer.device.type == "cuda":
        names = _ACTOR_KERNELS[net]
        if not any(launches[n] for n in names):
            findings.append(Finding(
                tag, 0, "QF901",
                f"the fxp8 actors launched no {'/'.join(names)} kernel "
                "on the card — the audited program is not the card's"))

    # QF901b: threaded-state parity across the step
    for name in _SLOTS:
        for msg in state_parity_mismatches(getattr(state, name),
                                           getattr(out, name), name):
            findings.append(Finding(
                tag, 0, "QF901", f"threaded-state drift: {msg}"))

    # QF904: the state written in place kept its storage
    for path in storage_mismatches(before, out):
        findings.append(Finding(
            tag, 0, "QF904",
            f"{path} left its storage during the iteration — a whole "
            "copy of state the reference donates (write it in place)"))
    if held is not None:
        kind = (trainer.family if state.replay is None
                else f"{trainer.family}/{trainer.replay}")
        held.setdefault(kind, sorted(before))

    # QF902: packed-weight grids, at the serving/actor precisions
    findings.extend(audit_qtensor_grids(state.params, 8, tag))
    findings.extend(audit_qtensor_grids(state.params, 4, tag))
    return findings


class BucketRecorder:
    """Wraps a ``PolicyServer``'s forward and records the row count of
    every forward it runs, during ``warmup()`` and after."""

    def __init__(self, server):
        self.warm: List[int] = []
        self.served: List[int] = []
        self._phase = self.warm
        run = server._run

        def recorded(obs):
            self._phase.append(int(obs.shape[0]))
            return run(obs)

        server._run = recorded

    def serving(self):
        """Every forward from now on answers requests."""
        self._phase = self.served


def audit_buckets(env_name: str = "cartpole", net: str = "mlp",
                  max_bucket: int = 8,
                  device: DeviceLike = None) -> List[Finding]:
    """QF903 on a real PolicyServer: warm it, sweep request sizes across
    the ladder, then check every forward against the ladder."""
    from repro_torch.rl.inference import build_env, make_value_agent
    from repro_torch.serve.engine import PolicyServer
    from repro_torch.serve.loader import ServedPolicy

    tag = f"trace:{env_name}/{net}/serve/w8"
    dev = resolve_device(device)
    env = build_env(env_name, net)
    agent = make_value_agent("dqn", env.spec,
                             torch.Generator().manual_seed(0), net=net,
                             device=dev)
    policy = ServedPolicy.from_agent(agent, env_name, net=net)
    server = PolicyServer(policy, precision="w8", max_bucket=max_bucket)
    rec = BucketRecorder(server)
    server.warmup()
    rec.serving()
    obs_shape = tuple(policy.env.obs_shape)
    # odd request sizes spanning every bucket + an overflow chunk
    for n in [1, 2, 3, max_bucket, max_bucket + 1]:
        server.act(torch.zeros((n,) + obs_shape, dtype=torch.float32,
                               device=dev))
    return check_bucket_ladder(server, rec, tag)


def check_bucket_ladder(server, rec: BucketRecorder,
                        tag: str) -> List[Finding]:
    findings: List[Finding] = []
    ladder = set(server.buckets)
    off = sorted({n for n in rec.warm + rec.served if n not in ladder})
    if off:
        findings.append(Finding(
            tag, 0, "QF903",
            f"forwards of {off} rows ran off the bucket ladder "
            f"{server.buckets} — a shape leak past the pad-to-bucket "
            "boundary"))
    if server._warm != ladder:
        findings.append(Finding(
            tag, 0, "QF903",
            f"bucket ladder {server.buckets} warmed {sorted(server._warm)}"
            " — every bucket must run once in warmup()"))
    cold = sorted({n for n in rec.served if n in ladder}
                  - set(rec.warm))
    if cold:
        findings.append(Finding(
            tag, 0, "QF903",
            f"buckets {cold} ran for the first time after warmup() — a "
            "first-call cost inside a request latency"))
    return findings


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def run_trace_audit(fast: bool = False,
                    combos: Optional[List[Tuple[str, str, str, str]]]
                    = None, device: DeviceLike = None) -> TraceResult:
    """Sweep the accepted combos on ``device`` (default: the card).
    ``fast`` keeps one representative per (net, algo, precision)
    family instead of every env — the per-family program structure is
    identical, only shapes differ."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dev = resolve_device(device)
    all_combos = combos if combos is not None else accepted_combos()
    if fast:
        seen, picked = set(), []
        for c in all_combos:
            k = c[1:]
            if k not in seen:
                seen.add(k)
                picked.append(c)
        all_combos = picked

    findings: List[Finding] = []
    checked: List[str] = []
    held: Dict[str, List[str]] = {}
    total: Dict[str, int] = {}

    def count():
        for k, v in launch_counts().items():
            total[k] = total.get(k, 0) + v

    for env_name, net, algo, precision in all_combos:
        findings.extend(audit_step(env_name, net, algo, precision,
                                   device=dev, held=held))
        count()
        checked.append(_combo_tag(env_name, net, algo, precision))

    for env_name, net, algo, precision, rep in SHARDED_VALUE_COMBOS:
        findings.extend(audit_step(env_name, net, algo, precision,
                                   sharded_replay=rep, device=dev,
                                   held=held))
        count()
        checked.append(_combo_tag(env_name, net, algo, precision)
                       + f"/sharded-{rep}")

    # the serving ladder, on both torso families
    for env_name, net, top in (("cartpole", "mlp", 8), ("catch", "conv", 4)):
        reset_launch_counts()
        findings.extend(audit_buckets(env_name, net, max_bucket=top,
                                      device=dev))
        count()
        checked.append(f"trace:{env_name}/{net}/serve/w8")
    return TraceResult(findings=findings, combos_checked=checked,
                       held=held, launches=total)
