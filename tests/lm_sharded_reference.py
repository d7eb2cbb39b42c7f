"""The JAX package's side of test_torch_lm_sharded.py, on 8 host
devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        PYTHONPATH=src:tests python tests/lm_sharded_reference.py IN OUT

reads the cases the test drew (a pickle of numpy trees) and writes every
result to one npz, each leaf under ``<case>/<path>``:

* ``train/<arch>``: the reference's jitted ``make_train_step(cfg,
  make_host_mesh(), ...)`` on the placed batch (its gradient
  recorded at ``adamw_update``), and the int8 codes of its jitted
  forward's dense products (``jax.debug.callback``, in program order);
* ``moe/<case>``: ``moe_shard_map`` on ``jax.make_mesh((2, 4), ("data",
  "model"))``, its output and gradients, and each slot's routing;
* ``place``: each device's rows of the placed batch;
* ``layout``: ``make_shardings`` of the cases' trees on the (2, 4) mesh,
  as each device's slice bounds (``devices_indices_map``);
* ``cli/losses``: the reference's ``train`` of the reduced tinyllama on
  the 8-device host mesh, a loss logged every step.

Everything runs jitted with the reference's own primitives (the
``one_library`` callbacks of the single-device tests deadlock XLA's
host collectives across 8 devices).
"""
import math
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as jreg  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import qmatmul as jqm  # noqa: E402
from repro.data import place  # noqa: E402
from repro.distributed.sharding import (make_shardings,  # noqa: E402
                                        mesh_rules)
from repro.core.fxp import QTensor  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import registry as jmodels  # noqa: E402
from repro.nn import moe_shard as jmoe_shard  # noqa: E402
from repro.optim import warmup_cosine  # noqa: E402
from repro_torch.tree import leaves_with_path, path_str  # noqa: E402

N_DEVICES = 8


def _flat(prefix, tree):
    """``{prefix/path: array}`` of a tree (a QTensor as its payload and
    scale, ``#q`` and ``#s``)."""
    out = {}
    is_q = lambda x: hasattr(x, "qvalue")  # noqa: E731
    for path, leaf in leaves_with_path(tree, is_leaf=is_q):
        key = "/".join(filter(None, [prefix, path_str(path)]))
        if is_q(leaf):
            out[key + "#q"] = np.asarray(leaf.qvalue)
            out[key + "#s"] = np.asarray(leaf.scale)
        else:
            out[key] = np.asarray(leaf)
    return out


def _unrolled_scan(f, init, xs=None, length=None, reverse=False, **kw):
    """``jax.lax.scan`` as a Python loop over the leading axis."""
    assert not reverse
    n = length if xs is None else jax.tree.leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        x = None if xs is None else jax.tree.map(lambda a: a[i], xs)
        carry, y = f(carry, x)
        ys.append(y)
    if all(y is None for y in ys):
        return carry, None
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def train(name, c):
    cfg = jreg.get_arch(c["arch"]).reduced().replace(q_chunk=c["q_chunk"])
    pol = jpolicy.get_policy(c["policy"])
    mesh = make_host_mesh()
    params, opt = jax.tree.map(jnp.asarray, (c["params"], c["opt"]))
    batch = place(c["batch"], mesh)
    seq = c["batch"]["tokens"].shape[1]
    model = jmodels.model_for(cfg)
    rules = jmodels.sharding_rules(cfg, 1)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the forward's codes: each loop unrolled, no remat and the
        # product's forward called without its custom_vjp (none of those
        # scopes can hand its tracers out), the codes returned by the jit
        codes = []
        orig = jqm.quantize_rowwise

        def record(x, bits):
            q, s = orig(x, bits)
            if x.ndim == 3 and x.shape[1] == seq:
                codes.append(q)
            return q, s

        def forward(p, b):
            codes.clear()
            loss = model.loss_fn(p, b, cfg, pol)
            return loss, list(codes)

        with pytest.MonkeyPatch.context() as unrolled:
            unrolled.setattr(jqm, "quantize_rowwise", record)
            unrolled.setattr(jax.lax, "scan", _unrolled_scan)
            unrolled.setattr(jax.lax, "map", lambda f, xs: _unrolled_scan(
                lambda c, x: (c, f(x)), None, xs)[1])
            unrolled.setattr(jax, "checkpoint", lambda f=None, **kw: f
                             if f is not None else (lambda g: g))
            unrolled.setattr(jqm, "_qmm", jqm._fwd_quantized)
            with mesh_rules(mesh, rules):
                _, got = jax.jit(forward)(params, batch)
        for i, q in enumerate(got):
            out[f"train/{name}/codes/{i}"] = np.asarray(q)

        update = jsteps.adamw_update

        def recording(g, *a, **kw):
            new_p, new_o, stats = update(g, *a, **kw)
            return new_p, new_o, dict(stats, grads=g)

        mp.setattr(jsteps, "adamw_update", recording)
        step = jsteps.make_train_step(
            cfg, mesh, pol,
            schedule=warmup_cosine(c["lr"], c["warmup"], c["total"]))
        new_p, new_o, stats = jax.jit(step)(params, opt, batch)
    grads = stats.pop("grads")
    out.update(_flat(f"train/{name}/params", new_p))
    out.update(_flat(f"train/{name}/opt", new_o))
    out.update(_flat(f"train/{name}/stats", stats))
    out.update(_flat(f"train/{name}/grads", grads))
    return out


def moe(name, c):
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    n_data = 2
    pol = jpolicy.get_policy(c["policy"]) if c["policy"] else None
    x, ct = jnp.asarray(c["x"]), jnp.asarray(c["ct"])
    ws = tuple(jnp.asarray(c[k]) for k in ("router", "w_gate", "w_up",
                                            "w_down"))
    out = {}

    def fwd(x, *ws):
        return jmoe_shard.moe_shard_map(
            x, *ws, mesh, top_k=c["top_k"],
            capacity_factor=c["capacity_factor"], policy=pol, act="silu")

    y, vjp = jax.vjp(jax.jit(fwd), x, *ws)
    grads = jax.jit(vjp)(ct)
    out[f"moe/{name}/out"] = np.asarray(y)
    for k, g in zip(("dx", "d_router", "d_w_gate", "d_w_up", "d_w_down"),
                    grads, strict=True):
        out[f"moe/{name}/{k}"] = np.asarray(g)
    # each slot's routing, as the shard_map body routes it
    B, S, D = x.shape
    E = ws[1].shape[0]
    b_loc = B // n_data
    cap = max(int(math.ceil(b_loc * S * c["top_k"] / E
                            * c["capacity_factor"])), 4)
    for d in range(n_data):
        xf = x[d * b_loc:(d + 1) * b_loc].reshape(-1, D)
        logits = xf.astype(jnp.float32) @ ws[0].astype(jnp.float32)
        idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                            c["top_k"])[1].reshape(-1)
        keep = jmoe_shard._local_dispatch(
            jnp.repeat(xf, c["top_k"], axis=0), idx, E, cap)[2]
        out[f"moe/{name}/experts/{d}"] = np.asarray(idx)
        out[f"moe/{name}/keep/{d}"] = np.asarray(keep)
    return out


def placements(batch, tree, axes):
    out = {}
    is_triple = lambda x: isinstance(x, tuple) and len(x) == 3 \
        and isinstance(x[2], int)  # noqa: E731
    tree = jax.tree.map(lambda t: QTensor(*t) if is_triple(t) else t, tree,
                        is_leaf=is_triple)
    host = make_host_mesh()
    placed = place(batch, host)
    position = {dev.id: i for i, dev in enumerate(host.devices.reshape(-1))}
    for k, arr in placed.items():
        for shard in arr.addressable_shards:
            out[f"place/{k}/{position[shard.device.id]}"] = \
                np.asarray(shard.data)
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    devices = list(mesh.devices.reshape(-1))
    shardings = make_shardings(tree, axes, mesh)
    is_q = lambda x: hasattr(x, "qvalue")  # noqa: E731
    s_at = dict(leaves_with_path(shardings, is_leaf=is_q))
    for path, leaf in leaves_with_path(tree, is_leaf=is_q):
        s = s_at[path]
        parts = ((("#q", leaf.qvalue, s.qvalue), ("#s", leaf.scale, s.scale))
                 if is_q(leaf) else (("", leaf, s),))
        for suffix, arr, sh in parts:
            index = sh.devices_indices_map(np.shape(arr))
            for r, dev in enumerate(devices):
                bounds = [(sl.start or 0, n if sl.stop is None else sl.stop)
                          for sl, n in zip(index[dev], np.shape(arr))]
                out[f"layout/{path_str(path)}{suffix}/{r}"] = \
                    np.asarray(bounds, np.int64).reshape(-1, 2)
    return out


def main(inp, outp):
    assert len(jax.devices()) == N_DEVICES, jax.devices()
    with open(inp, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, c in cases["train"].items():
        out.update(train(name, c))
    for name, c in cases["moe"].items():
        out.update(moe(name, c))
    out.update(placements(**cases["layout"]))
    c = cases["cli"]
    out["cli/losses"] = np.asarray(jtrain.train(
        "tinyllama-1.1b", steps=c["steps"], seq_len=c["seq_len"],
        batch=c["batch"], log_every=1, seed=0)[1])
    np.savez(outp, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
