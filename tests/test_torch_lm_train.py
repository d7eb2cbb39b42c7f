"""LM training of the PyTorch port (``launch.steps.make_train_step``:
every family's ``loss_fn`` differentiated by autograd, then AdamW)
against the JAX package's step, at the reduced configs (``q_chunk=16``,
a batch of 2 x 32 tokens; whisper's frames drawn with numpy).

The reference's params and an optimizer state a few steps in (moments
drawn with numpy) go to both packages (``from_numpy_tree``).  Both run
their own ``make_train_step`` unchanged; each package's
``adamw_update`` is wrapped to record the gradients it is handed.  The
reference runs op by op (``jax.disable_jit()``) under ``one_library``
(test_torch_lm_layers.py): its einsum, softmax, rsqrt, exp and the
rest are computed by the port's ``core.exact`` functions, so both
forwards quantize to the same int8 codes, and under ``jax.grad`` each
of those primitives takes its JAX derivative at the same inputs.
Tolerances:

* the loss: rtol 1e-6;
* each gradient leaf: within 1e-5 of that leaf's largest magnitude.
  The port's backward runs through ``core.exact``'s fp64 round trips
  and sums its products in another order, so it differs from the
  reference's fp32 backward by a few fp32 ulps of the larger terms;
* the new params and both moments: atol 1e-5 + rtol 1e-4; the count
  and the learning rate equal;
* under ``w8a8_bf16`` (the params cast to bf16 inside the
  differentiated function): the loss at rtol 1e-6 (the forwards agree:
  the same int8 codes, bf16 products rounded alike); every gradient
  leaf within 5e-2 of its largest magnitude; AdamW, given the
  reference's gradient, at the fp32 bar above.  A bf16 backward rounds
  every intermediate to 8 bits, and the port's differs from the
  reference's in where it rounds (``core.exact``'s functions
  differentiate in fp64, each library sums its bf16 products in its own
  order), so a few bf16 ulps part the two at each layer.  Measured
  (``python tests/test_torch_lm_train.py w8a8_bf16``), the port lies
  at most 3.3e-2 of a leaf's largest magnitude from the reference,
  while the reference lies up to 0.36 from itself when only its
  primitives' last bits change (``one_library`` on and off): 1e-2 is
  below what bf16 reproduces.

The microbatch branch (``microbatches=2``) is held to the fp32 bars at
one dense and one MoE configuration, ``w8a8_bf16`` at one configuration
of each family.  The second file,
test_torch_lm_train_run.py, holds the remaining families and the
behaviour of ``launch.train``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import policy as jpolicy
from repro.launch import steps as jsteps
from repro.models import registry as jmodels
from repro.nn.module import unbox
from repro.optim import adamw_init as jadamw_init
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.configs import registry as treg
from repro_torch.core import policy as tpolicy
from repro_torch.launch import steps as tsteps
from repro_torch.optim import adamw_update as tadamw_update
from repro_torch.optim import warmup_cosine as twarmup_cosine
from repro_torch.tree import leaves_with_path
from test_torch_lm_layers import one_library

__all__ = ["one_library"]          # the fixture, requested by name

ARCHS = sorted(jreg.ARCHS)
B, S = 2, 32
# the schedule ``train(steps=50)`` builds; the drawn state is at count 3
LR, WARMUP, TOTAL, COUNT = 3e-4, 5, 50, 3

# one configuration of each family
FAMILIES = ["tinyllama-1.1b", "qwen3-moe-30b-a3b", "whisper-large-v3",
            "mamba2-2.7b", "recurrentgemma-9b"]
# this file's share of the families; the rest in test_torch_lm_train_run
HERE = ["chameleon-34b", "phi3-mini-3.8b", "qwen2-72b", "stablelm-12b",
        "tinyllama-1.1b", "whisper-large-v3"]


def setup_step(arch, policy, seed=0, microbatches=1):
    """(reference, port) inputs of one step: each a (cfg, policy, params,
    opt_state, batch) of its package, made from the same numbers."""
    jc = jreg.get_arch(arch).reduced().replace(q_chunk=16,
                                               microbatches=microbatches)
    tc = treg.get_arch(arch).reduced().replace(q_chunk=16,
                                               microbatches=microbatches)
    jparams = unbox(jmodels.model_for(jc).init(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    opt = jadamw_init(jparams)
    opt = {"mu": jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                         * 1e-3).astype(np.float32),
                              opt["mu"]),
           "nu": jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                         * 1e-3).astype(np.float32) ** 2,
                              opt["nu"]),
           "count": np.asarray(COUNT, np.int32)}
    base = rng.integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": base[:, :-1], "labels": base[:, 1:]}
    if jc.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, S, jc.d_model)).astype(np.float32)
    jtree = jax.tree.map(jnp.asarray, (jparams, opt, batch))
    ttree = from_numpy_tree(jax.tree.map(np.asarray, (jparams, opt, batch)),
                            "cpu")
    return ((jc, jpolicy.get_policy(policy)) + tuple(jtree),
            (tc, tpolicy.get_policy(policy)) + tuple(ttree))


def _recording(monkeypatch, module):
    """``module.adamw_update`` wrapped to record the gradients it gets."""
    seen = []
    orig = module.adamw_update

    def update(grads, *a, **kw):
        seen.append(grads)
        return orig(grads, *a, **kw)

    monkeypatch.setattr(module, "adamw_update", update)
    return seen


def reference_step(monkeypatch, ref):
    """The reference's ``make_train_step`` op by op: (params, opt_state,
    stats, grads) as the port's CPU trees."""
    cfg, pol, params, opt, batch = ref
    seen = _recording(monkeypatch, jsteps)
    step = jsteps.make_train_step(
        cfg, None, pol, schedule=jwarmup_cosine(LR, WARMUP, TOTAL))
    with jax.disable_jit():
        out = step(params, opt, batch)
    return from_numpy_tree(jax.tree.map(np.asarray, out + (seen[0],)),
                           "cpu")


def port_step(monkeypatch, port):
    cfg, pol, params, opt, batch = port
    seen = _recording(monkeypatch, tsteps)
    step = tsteps.make_train_step(
        cfg, None, pol, schedule=twarmup_cosine(LR, WARMUP, TOTAL))
    return step(params, opt, batch) + (seen[0],)


def _leaves(tree):
    return dict(leaves_with_path(tree))


def _within(got, want, atol, rtol=0.0, what=""):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), path
        np.testing.assert_allclose(
            g.float().numpy(), w.float().numpy(), rtol=rtol,
            atol=atol(w), err_msg=f"{what} {path}")


def of_largest(frac):
    """An absolute bound of ``frac`` of a leaf's largest magnitude."""
    return lambda w: frac * float(w.abs().max()) if w.numel() else 0.0


def compare_update(got, want):
    """New params, moments, count and stats of each package."""
    g_params, g_opt, g_stats = got
    w_params, w_opt, w_stats = want
    _within(g_params, w_params, lambda w: 1e-5, 1e-4, "param")
    for m in ("mu", "nu"):
        _within(g_opt[m], w_opt[m], lambda w: 1e-5, 1e-4, m)
    assert int(g_opt["count"]) == int(w_opt["count"]) == COUNT + 1
    assert float(g_stats["lr"]) == float(w_stats["lr"])
    np.testing.assert_allclose(float(g_stats["grad_norm"]),
                               float(w_stats["grad_norm"]), rtol=1e-5)
    assert int(g_stats["nonfinite"]) == int(w_stats["nonfinite"]) == 0


def check_step(request, monkeypatch, arch, policy="w8a8", microbatches=1,
               grad_frac=1e-5):
    """One step of each package from the same state, held to the bars
    of the module docstring (``grad_frac``: the gradient bar)."""
    ref, port = setup_step(arch, policy, microbatches=microbatches)
    request.getfixturevalue("one_library")   # after the reference's init
    want = reference_step(monkeypatch, ref)
    got = port_step(monkeypatch, port)
    np.testing.assert_allclose(float(got[2]["loss"]), float(want[2]["loss"]),
                               rtol=1e-6)
    _within(got[3], want[3], of_largest(grad_frac), what="grad")
    if grad_frac > 1e-5:
        # bf16: AdamW given the reference's gradient
        with torch.no_grad():
            got = tadamw_update(want[3], port[3], port[2],
                                twarmup_cosine(LR, WARMUP, TOTAL))
    compare_update(got[:3], want[:3])


@pytest.mark.parametrize("arch", HERE)
def test_train_step_matches_the_reference(request, monkeypatch, arch):
    check_step(request, monkeypatch, arch)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b"])
def test_microbatched_step_matches_the_reference(request, monkeypatch,
                                                 arch):
    """Two microbatches of one sequence each: losses and fp32 gradients
    summed in the reference's order, then over k."""
    check_step(request, monkeypatch, arch, microbatches=2)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_compute_cast_step(request, monkeypatch, arch):
    """``w8a8_bf16``: the fp32 matrices cast to bf16 inside the
    differentiated function, the gradients fp32, at bf16's bar."""
    check_step(request, monkeypatch, arch, policy="w8a8_bf16",
               grad_frac=5e-2)


def test_every_family_is_held():
    from test_torch_lm_train_run import HERE as THERE
    assert sorted(HERE + THERE) == ARCHS
    assert {jreg.ARCHS[a].family for a in ARCHS} == {
        "dense", "moe", "encdec", "ssm", "hybrid"}


def _worst(got, want):
    """(largest |got - want| over a leaf's largest |want|, leaf path)."""
    got, want = _leaves(got), _leaves(want)
    return max(((float((got[k].float() - w.float()).abs().max())
                 / (float(w.abs().max()) or 1.0), k)
                for k, w in want.items()), key=lambda t: t[0])


def measure(policy, archs):
    """Print, for each arch, the gradient differences the module
    docstring quotes: the port against the reference under
    ``one_library``, and the reference under ``one_library`` against
    the reference with its own primitives."""
    for arch in archs:
        ref, port = setup_step(arch, policy)
        with pytest.MonkeyPatch.context() as mp:
            own = reference_step(mp, ref)
        with pytest.MonkeyPatch.context() as mp:
            one_library.__wrapped__(mp)
            want = reference_step(mp, ref)
            got = port_step(mp, port)
        loss = abs(float(got[2]["loss"]) / float(want[2]["loss"]) - 1)
        print(f"{arch} {policy}: loss rel {loss:.2e}; "
              f"port vs reference {_worst(got[3], want[3])}; "
              f"reference vs itself {_worst(own[3], want[3])}", flush=True)


if __name__ == "__main__":
    # PYTHONPATH=src:tests python tests/test_torch_lm_train.py POLICY [ARCH...]
    import sys
    measure(sys.argv[1], sys.argv[2:] or ARCHS)
