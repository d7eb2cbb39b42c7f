"""Quantized batched LM serving, a prefill and a decode loop (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --policy w8a8kv8 --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b

The dense decoder LMs, the MoE LMs (qwen3-moe, mixtral), the enc-dec
family (whisper), the ssm family (mamba2) and the hybrid
(recurrentgemma).  Weights PTQ'd to int8/int4 QTensors, activations int8
at every product (on the card, the Q-MAC kernel's fused product), the KV
cache int8 under ``w8a8kv8``, greedy or temperature sampling.

An MoE model is served with ``weight_ptq=False``, as the reference
serves it: the reference's PTQ gives the 4-D expert stacks ``[L, E, d,
f]`` one scale per out column shared by every layer and expert
(``[1, 1, 1, f]``), which its layer scan refuses, and the port's layer
walk refuses the same tree with the same ``ValueError`` before any
product.  With fp weights every product quantizes its weight at each
call: attention and the head through Q-MAC's int32 kernel, the experts
through its batched fused kernel with per-(expert, out-channel)
scales.  Runs on the card unless ``device="cpu"`` /
``--device cpu`` is given.  ``serve`` draws the weights, PTQs them and
calls :func:`generate`, the prefill and decode loop; a caller holding
one fp32 tree can PTQ it per policy (:func:`ptq`) and call
:func:`generate` on each.

As in the reference, ``--smoke`` is ``store_true`` with a default of
True, so the CLI always serves the reduced config; the published widths
are reached through ``serve(arch, smoke=False)``.  The reference's
``serve`` imports ``make_host_mesh`` and never calls it: it serves on
one device with no mesh, and so does this one.  (A caller who wants a
mesh builds ``launch.steps.make_prefill_step`` / ``make_decode_step``
on one.)
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.fxp import div_scalar
from repro_torch.core.policy import get_policy
from repro_torch.core.quantizer import quantize_params, quantized_nbytes
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import model_for

Tensor = torch.Tensor


def pad_caches(caches, extra: int):
    """Grow attention-cache capacity by ``extra`` zero slots (prefill
    built them at prompt length; decode needs prompt + gen).  Ring
    buffers (marked by 'pos') pass through unchanged."""

    def walk(node):
        if isinstance(node, dict):
            if "k" in node and "v" in node and "pos" not in node:
                out = dict(node)
                for key in ("k", "v", "k_scale", "v_scale"):
                    if key in node:
                        arr = node[key]
                        t_axis = arr.ndim - 3
                        shape = list(arr.shape)
                        shape[t_axis] = extra
                        out[key] = torch.cat([arr, arr.new_zeros(shape)],
                                             dim=t_axis)
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(caches)


def gumbel(gen: torch.Generator, shape, device) -> Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in [tiny, 1),
    drawn on the CPU generator (the same draws on every device)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def sample(logits: Tensor, temperature: float, g=None) -> Tensor:
    """The next token [B, 1] int32: argmax at ``temperature <= 0``, else
    the Gumbel argmax ``jax.random.categorical`` computes,
    ``argmax(g + logits / temperature)`` with Gumbel draws ``g``."""
    if temperature <= 0:
        return torch.argmax(logits, -1, keepdim=True).to(torch.int32)
    scaled = div_scalar(logits, temperature)
    return torch.argmax(g + scaled, -1, keepdim=True).to(torch.int32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ptq(params, policy, verbose: bool = True):
    """The weights PTQ'd to ``policy``'s QTensors (printing their size
    against fp32)."""
    params = quantize_params(params, policy)
    stored, fp32 = quantized_nbytes(params)
    if verbose:
        print(f"PTQ weights: {stored / 2**20:.1f} MiB "
              f"(fp32 {fp32 / 2**20:.1f} MiB, "
              f"{fp32 / max(stored, 1):.2f}x smaller)")
    return params


@torch.no_grad()
def generate(model, params, cfg, policy, batch: int = 4,
             prompt_len: int = 32, gen: int = 16, temperature: float = 0.0,
             seed: int = 0, verbose: bool = True,
             device: DeviceLike = None):
    """Prompts from ``seed + 1``, a prefill, ``pad_caches`` and a decode
    loop of ``model`` on ``params`` (on ``device``); returns (tokens
    [batch, gen] int32, {"t_prefill", "t_decode"} in seconds on the host
    clock, each ended by a wait for the card).

    An enc-dec config (whisper) also takes stub frame embeddings
    ``[batch, prompt_len, d_model]``, as the reference does: the encoder
    is as long as the prompt.  The ``seed + 1`` generator draws the
    frames (standard normals) first, then the prompts, then any Gumbel
    draws."""
    dev = resolve_device(device)
    draws = torch.Generator().manual_seed(seed + 1)
    if cfg.is_encdec:
        frames = torch.randn((batch, prompt_len, cfg.d_model),
                             generator=draws).to(dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=draws).to(torch.int32).to(dev)
    batch_in = {"frames": frames, "tokens": prompts} if cfg.is_encdec \
        else prompts
    kv_bits = policy.kv_bits

    def next_token(logits):
        g = None if temperature <= 0 else gumbel(draws, logits.shape, dev)
        return sample(logits, temperature, g)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch_in, cfg, policy, kv_bits)
    caches = pad_caches(caches, gen)     # capacity: prompt_len + gen
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    token = next_token(logits)
    out_tokens = [token]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = model.decode_step(params, token, caches,
                                           prompt_len + i, cfg, policy,
                                           kv_bits)
        token = next_token(logits)
        out_tokens.append(token)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    toks = torch.cat(out_tokens, dim=1)
    if verbose:
        print(f"prefill: {batch}x{prompt_len} tok in {t_prefill:.3f}s "
              f"({batch * prompt_len / max(t_prefill, 1e-9):.0f} tok/s)")
        print(f"decode:  {batch}x{gen - 1} tok in {t_decode:.3f}s "
              f"({batch * (gen - 1) / max(t_decode, 1e-9):.0f} tok/s)")
        print(f"sample output ids: {toks[0, :10].tolist()}")
    return toks, {"t_prefill": t_prefill, "t_decode": t_decode}


@torch.no_grad()
def serve(arch: str, smoke: bool = True, policy_name: str = "w8a8kv8",
          batch: int = 4, prompt_len: int = 32, gen: int = 16,
          temperature: float = 0.0, seed: int = 0,
          weight_ptq: bool = True, verbose: bool = True,
          device: DeviceLike = None):
    """Random weights from ``seed``, PTQ'd to ``policy_name``, then
    :func:`generate` (prompts from ``seed + 1``); returns its tokens and
    times."""
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    policy = get_policy(policy_name)
    model = model_for(cfg)
    dev = resolve_device(device)

    params = model.init(torch.Generator().manual_seed(seed), cfg,
                        device=dev)
    if weight_ptq and policy.quantized_w:
        params = ptq(params, policy, verbose)
    return generate(model, params, cfg, policy, batch, prompt_len, gen,
                    temperature, seed, verbose, dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--policy", default="w8a8kv8")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    serve(args.arch, args.smoke, args.policy, args.batch,
          args.prompt_len, args.gen, args.temperature,
          device=args.device)


if __name__ == "__main__":
    main()
