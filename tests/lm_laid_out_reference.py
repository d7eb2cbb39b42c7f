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

Everything runs jitted with the reference's own primitives.
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.configs import registry as jreg
from repro.core import policy as jpolicy
from repro.launch import steps as jsteps
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


def main(inp, outp):
    assert len(jax.devices()) == N_DEVICES, jax.devices()
    with open(inp, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, c in cases.items():
        out.update(case(name, c))
    np.savez(outp, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
