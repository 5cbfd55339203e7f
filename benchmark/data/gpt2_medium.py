"""A training job's state of GPT-2 medium: its parameters in bfloat16, a step and an rng pair.

The shapes are those of the public gpt2-medium ``config.json`` (``n_layer``,
``n_embd``, ``n_positions``, ``vocab_size`` in ``params``), in the original
GPT-2 names: ``wte`` (vocab_size, n_embd), ``wpe`` (n_positions, n_embd),
``h`` a list of ``n_layer`` blocks, each ``ln_1`` / ``ln_2`` (gain ``g`` and
bias ``b`` of n_embd), ``attn.c_attn`` (w (n_embd, 3 n_embd), b),
``attn.c_proj`` (n_embd, n_embd), ``mlp.c_fc`` (n_embd, 4 n_embd) and
``mlp.c_proj`` (4 n_embd, n_embd), then ``ln_f``.  At the published sizes
that is 292 tensors of 354,823,168 values.  Every value is N(0, init_std)
drawn in float32 on the device from the seed and rounded to the dtype.
Besides ``params`` the state holds the int ``step`` 1000 and the int64
tensor ``rng`` = [seed, seed + 1].
"""

from __future__ import annotations

import math

import torch

STEP = 1000


def _layer_shapes(e: int) -> dict:
    def dense(n_in, n_out):
        return {"w": (n_in, n_out), "b": (n_out,)}

    return {"ln_1": {"g": (e,), "b": (e,)},
            "attn": {"c_attn": dense(e, 3 * e), "c_proj": dense(e, e)},
            "ln_2": {"g": (e,), "b": (e,)},
            "mlp": {"c_fc": dense(e, 4 * e), "c_proj": dense(4 * e, e)}}


def shapes(params: dict) -> dict:
    """The parameters' tree with each leaf's shape in its place; nothing
    is allocated."""
    e = params["n_embd"]
    return {"wte": (params["vocab_size"], e), "wpe": (params["n_positions"], e),
            "h": [_layer_shapes(e) for _ in range(params["n_layer"])],
            "ln_f": {"g": (e,), "b": (e,)}}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def state_bytes(params: dict, dtype: torch.dtype) -> int:
    """Tensor bytes of the whole state: the parameters in ``dtype`` and
    the int64 rng pair."""
    values = sum(math.prod(s) for s in _leaves(shapes(params)))
    return values * dtype.itemsize + 2 * torch.int64.itemsize


def make(nbytes: int, dtype: torch.dtype, seed: int, device: torch.device,
         params: dict) -> dict:
    """The state on ``device`` from ``seed``; ValueError unless it holds
    ``nbytes`` tensor bytes."""
    want = state_bytes(params, dtype)
    if nbytes != want:
        raise ValueError(f"the state holds {want} tensor bytes, not {nbytes}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    std = params["init_std"]

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        x = torch.randn(node, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(std).to(dtype)

    rng = torch.tensor([seed, seed + 1], dtype=torch.int64, device=device)
    return {"params": build(shapes(params)), "step": STEP, "rng": rng}
