"""The JAX package's side of test_torch_lm_laid_out.py, on 8 host
devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        PYTHONPATH=src:tests python tests/lm_laid_out_reference.py IN OUT

reads the cases the test drew (a pickle of numpy trees) and writes every
result to one npz, each leaf under ``<case>/<path>``:

* ``<case>/init/<path>/<r>``: the case's params put on its (data, model)
  mesh by ``make_shardings`` (``launch.steps.abstract_params``), the
  addressable shard of the mesh's ``r``-th device;
* ``<case>/{params,opt,stats,grads}/<path>``: the reference's
  ``make_train_step(cfg, mesh, ...)`` jitted with ``in_shardings=(p_shard,
  o_shard, batch shardings)``, as ``lower_cell`` jits it, on the global
  batch (its gradient recorded at ``adamw_update``).

A serving case (one with ``prompts``) writes instead:

* ``<case>/{pre,dec}/<path>[/.qvalue|/.scale]/<r>``: the params PTQ'd
  whole (``quantize_params``) and put on the mesh by ``make_shardings``
  under the FSDP+TP rules (``pre``) and the serve rules (``dec``), the
  addressable shard of the ``r``-th device;
* ``<case>/layout_caches/<path>/<r>``: the case's ``layout_caches`` put
  on the mesh by ``cache_shardings`` of the decode's caches;
* ``<case>/prefill/{logits,caches/<path>}``: ``make_prefill_step``
  jitted with ``in_shardings=(pre shardings, batch shardings)``, as
  ``lower_cell`` jits it, on the global prompts;
* ``<case>/decode/<i>/logits`` and ``<case>/decode/caches/<path>``: its
  caches grown by ``pad_caches`` and put on the mesh by
  ``cache_shardings``, then ``make_decode_step`` jitted with
  ``in_shardings=(dec shardings, cache shardings, batch shardings,
  replicated)`` for each fed token, the caches after the last.

Everything runs jitted with the reference's own primitives.
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from jax.sharding import NamedSharding, PartitionSpec

from repro.configs import registry as jreg
from repro.core import policy as jpolicy
from repro.core.fxp import QTensor
from repro.core.quantizer import quantize_params
from repro.launch import steps as jsteps
from repro.launch.serve import pad_caches
from repro.optim import warmup_cosine
from repro_torch.tree import leaves_with_path, path_str

N_DEVICES = 8


def _flat(prefix, tree):
    return {f"{prefix}/{path_str(p)}": np.asarray(v)
            for p, v in leaves_with_path(tree)}


def case(name, c):
    cfg = jreg.get_arch(c["arch"]).reduced().replace(q_chunk=c["q_chunk"],
                                                    **c["extra"])
    pol = jpolicy.get_policy(c["policy"])
    # the devices in the ranks' order, axes left to the partitioner
    mesh = Mesh(np.asarray(jax.devices()).reshape(tuple(c["shape"])),
                ("data", "model"))
    devices = list(mesh.devices.reshape(-1))
    abs_params, p_shard = jsteps.abstract_params(cfg, mesh)
    _, o_shard = jsteps.abstract_opt_state(abs_params, p_shard, mesh)
    params = jax.device_put(jax.tree.map(jnp.asarray, c["params"]), p_shard)
    out = {}
    for path, leaf in leaves_with_path(params):
        by_dev = {s.device.id: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        for r, dev in enumerate(devices):
            out[f"{name}/init/{path_str(path)}/{r}"] = by_dev[dev.id]
    opt = jax.tree.map(jnp.asarray, c["opt"])
    batch = {k: jnp.asarray(v) for k, v in c["batch"].items()}
    b_shard = jsteps.batch_shardings(batch, mesh)
    with pytest.MonkeyPatch.context() as mp:
        update = jsteps.adamw_update

        def recording(g, *a, **kw):
            new_p, new_o, stats = update(g, *a, **kw)
            return new_p, new_o, dict(stats, grads=g)

        mp.setattr(jsteps, "adamw_update", recording)
        step = jsteps.make_train_step(
            cfg, mesh, pol,
            schedule=warmup_cosine(c["lr"], c["warmup"], c["total"]))
        new_p, new_o, stats = jax.jit(
            step, in_shardings=(p_shard, o_shard, b_shard))(
                params, opt, batch)
    grads = stats.pop("grads")
    for what, tree in (("params", new_p), ("opt", new_o), ("stats", stats),
                       ("grads", grads)):
        out.update(_flat(f"{name}/{what}", tree))
    return out


def _shards(prefix, tree, devices):
    """Each device's addressable shard of every array of ``tree`` (a
    QTensor's payload and scale apart), by ``<prefix>/<path>/<r>``."""
    out = {}
    for path, leaf in leaves_with_path(tree):
        parts = ((f"{path_str(path)}/.qvalue", leaf.qvalue),
                 (f"{path_str(path)}/.scale", leaf.scale)) \
            if isinstance(leaf, QTensor) else ((path_str(path), leaf),)
        for key, arr in parts:
            by_dev = {s.device.id: np.asarray(s.data)
                      for s in arr.addressable_shards}
            for r, dev in enumerate(devices):
                out[f"{prefix}/{key}/{r}"] = by_dev[dev.id]
    return out


def serving_case(name, c):
    cfg = jreg.get_arch(c["arch"]).reduced().replace(q_chunk=c["q_chunk"],
                                                    **c["extra"])
    pol = jpolicy.get_policy(c["policy"])
    mesh = Mesh(np.asarray(jax.devices()).reshape(tuple(c["shape"])),
                ("data", "model"))
    devices = list(mesh.devices.reshape(-1))
    packed = quantize_params(jax.tree.map(jnp.asarray, c["params"]), pol)
    p_pre = jsteps.abstract_params(cfg, mesh, weight_ptq=pol)[1]
    p_dec = jsteps.abstract_params(cfg, mesh, weight_ptq=pol, serve=True)[1]
    pre, dec = jax.device_put(packed, p_pre), jax.device_put(packed, p_dec)
    out = {**_shards(f"{name}/pre", pre, devices),
           **_shards(f"{name}/dec", dec, devices)}
    prompts = {"tokens": jnp.asarray(c["prompts"])}
    logits, caches = jax.jit(
        jsteps.make_prefill_step(cfg, mesh, pol, pol.kv_bits),
        in_shardings=(p_pre, jsteps.batch_shardings(prompts, mesh)))(
            pre, prompts)
    out[f"{name}/prefill/logits"] = np.asarray(logits)
    out.update(_flat(f"{name}/prefill/caches", caches))
    caches = pad_caches(caches, len(c["fed"]))
    c_shard = jsteps.cache_shardings(caches, cfg, c["prompts"].shape[0],
                                     mesh)
    out.update(_shards(f"{name}/layout_caches", jax.device_put(
        jax.tree.map(jnp.asarray, c["layout_caches"]), c_shard), devices))
    token = jnp.asarray(c["fed"][0])
    decode = jax.jit(
        jsteps.make_decode_step(cfg, mesh, pol, pol.kv_bits),
        in_shardings=(p_dec, c_shard,
                      jsteps.batch_shardings({"t": token}, mesh)["t"],
                      NamedSharding(mesh, PartitionSpec())))
    caches = jax.device_put(caches, c_shard)
    S = c["prompts"].shape[1]
    for i, fed in enumerate(c["fed"]):
        logits, caches = decode(dec, caches, jnp.asarray(fed),
                                jnp.asarray(S + i, jnp.int32))
        out[f"{name}/decode/{i}/logits"] = np.asarray(logits)
    out.update(_flat(f"{name}/decode/caches", caches))
    return out


def main(inp, outp):
    assert len(jax.devices()) == N_DEVICES, jax.devices()
    with open(inp, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, c in cases.items():
        out.update(serving_case(name, c) if "prompts" in c
                   else case(name, c))
    np.savez(outp, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
