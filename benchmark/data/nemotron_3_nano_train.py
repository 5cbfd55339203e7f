"""A Nemotron-3-Nano training job's state sharded over the ranks of one node: fp32 master weights, bf16 Adam moments, a step and an rng pair.

The ranks hold pipeline stage 0 of stages of ``num_hidden_layers`` layers
(the embedding and the first layers of ``hybrid_override_pattern``: "M" a
Mamba2 layer, "E" a mixture-of-experts layer, "*" an attention layer),
every parameter a DTensor with ``Shard(0)`` over a one-dimensional mesh
of the node's ranks (FSDP2's layout).  An MoE layer holds
``n_routed_experts`` routed experts, stacked: the share of ranks 0-3 of
``expert_parallel``-way expert parallelism.  The parameters carry the
Hugging Face NemotronH names and the shapes of the public config's widths
(``params`` is the configuration file):

- every layer: ``backbone.layers.<i>.norm.weight`` (hidden,);
- Mamba2, d_inner = mamba_num_heads x mamba_head_dim, conv_dim = d_inner
  + 2 x n_groups x ssm_state_size: ``mixer.conv1d.weight`` (conv_dim, 1,
  conv_kernel) and ``.bias`` (conv_dim,), ``mixer.in_proj.weight``
  (conv_dim + d_inner + mamba_num_heads, hidden), ``mixer.dt_bias``,
  ``mixer.A_log``, ``mixer.D`` (mamba_num_heads,), the gated norm
  ``mixer.norm.weight`` (d_inner,), ``mixer.out_proj.weight`` (hidden,
  d_inner);
- MoE, not gated (relu2): ``mixer.experts.up_proj`` (E,
  moe_intermediate_size, hidden) and ``mixer.experts.down_proj`` (E,
  hidden, moe_intermediate_size), the router ``mixer.gate.weight``
  (n_routed_experts_published, hidden) with its
  ``e_score_correction_bias``, whose width stays the published count of
  experts, and ``mixer.shared_experts.up_proj.weight`` /
  ``down_proj.weight`` of moe_shared_expert_intermediate_size;
- attention: ``mixer.q_proj.weight`` (heads x head_dim, hidden),
  ``k_proj`` and ``v_proj`` (kv heads x head_dim, hidden), ``o_proj``
  (hidden, heads x head_dim);
- ``backbone.embeddings.weight`` (vocab_size, hidden).

At the published widths and layers 0-6 ("MEMEM*E") that is 54 tensors of
1,510,737,216 values.  The state is ``{"master": {name: fp32}, "exp_avg":
{name: bf16}, "exp_avg_sq": {name: bf16}, "step": step, "rng": int64
[seed, seed + 1]}``: 162 sharded leaves, numbered master first, in that
order, then the rng pair, which every rank holds whole (process 0 writes
it).  A rank's shard of leaf ``leaf`` is drawn on its device from its own
generator, seeded from (seed, leaf, rank), so any process can draw any
rank's shard again.  The draws are the DeepSeek-V2-Lite state's
(``deepseek_v2_lite_train.py``): master N(0, init_std), RMSNorm weights
and ``D`` 1 + N(0, norm_std), ``exp_avg`` N(0, moment_std),
``exp_avg_sq`` the square of an N(0, moment_std) draw, each drawn in
float32 and rounded to its dtype; and Mamba2's own initialisation of
``A_log`` (the log of U[1, 16]) and ``dt_bias`` (the inverse softplus of
exp(U[log time_step_min, log time_step_max]), at least
time_step_floor).
"""

from __future__ import annotations

import importlib.util
import math
import os

import torch


def _deepseek():
    """``deepseek_v2_lite_train.py`` beside this file: its state recipe."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_data_nemotron_deepseek_v2_lite_train",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "deepseek_v2_lite_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GROUPS = _deepseek().GROUPS
KINDS = {"M": "mamba", "E": "moe", "*": "attention"}


def layer_kinds(params: dict) -> list:
    """The held layers' kinds, from the pattern's first characters."""
    pattern = params["hybrid_override_pattern"][: params["num_hidden_layers"]]
    if len(pattern) != params["num_hidden_layers"] or set(pattern) - set(KINDS):
        raise ValueError(f"layers {pattern!r}: only M, E and * are known")
    return [KINDS[c] for c in pattern]


def parameter_shapes(params: dict) -> dict:
    """{parameter name: global shape}, in the Hugging Face module order."""
    h = params["hidden_size"]
    heads, hd = params["mamba_num_heads"], params["mamba_head_dim"]
    d_inner = heads * hd
    conv_dim = d_inner + 2 * params["n_groups"] * params["ssm_state_size"]
    experts, width = params["n_routed_experts"], params["moe_intermediate_size"]
    shared = params["moe_shared_expert_intermediate_size"]
    q = params["num_attention_heads"] * params["head_dim"]
    kv = params["num_key_value_heads"] * params["head_dim"]
    out = {"backbone.embeddings.weight": (params["vocab_size"], h)}
    for i, kind in enumerate(layer_kinds(params)):
        p = f"backbone.layers.{i}"
        out[f"{p}.norm.weight"] = (h,)
        m = f"{p}.mixer"
        if kind == "mamba":
            out.update({f"{m}.conv1d.weight": (conv_dim, 1, params["conv_kernel"]),
                        f"{m}.conv1d.bias": (conv_dim,),
                        f"{m}.in_proj.weight": (conv_dim + d_inner + heads, h),
                        f"{m}.dt_bias": (heads,), f"{m}.A_log": (heads,), f"{m}.D": (heads,),
                        f"{m}.norm.weight": (d_inner,),
                        f"{m}.out_proj.weight": (h, d_inner)})
        elif kind == "moe":
            out.update({f"{m}.experts.up_proj": (experts, width, h),
                        f"{m}.experts.down_proj": (experts, h, width),
                        f"{m}.gate.weight": (params["n_routed_experts_published"], h),
                        f"{m}.gate.e_score_correction_bias":
                            (params["n_routed_experts_published"],),
                        f"{m}.shared_experts.up_proj.weight": (shared, h),
                        f"{m}.shared_experts.down_proj.weight": (h, shared)})
        else:
            out.update({f"{m}.q_proj.weight": (q, h), f"{m}.k_proj.weight": (kv, h),
                        f"{m}.v_proj.weight": (kv, h), f"{m}.o_proj.weight": (h, q)})
    return out


def leaf_specs(params: dict) -> list:
    """[(group, parameter name, global shape, dtype)] of the sharded
    leaves, in leaf order."""
    names = parameter_shapes(params)
    return [(group, name, shape, dtype) for group, dtype in GROUPS
            for name, shape in names.items()]


def rows(n: int, world: int, rank: int) -> tuple[int, int]:
    """The rows [start, stop) of dimension 0 that ``rank`` of ``world``
    holds under ``Shard(0)`` (``torch.chunk``'s split)."""
    piece = -(-n // world)
    return min(rank * piece, n), min((rank + 1) * piece, n)


def shapes(params: dict) -> dict:
    """The state's tree with every tensor leaf, whole, on the meta device
    (its global shape and dtype; nothing is allocated) and the step in its
    place."""
    tree = {group: {} for group, _ in GROUPS}
    for group, name, shape, dtype in leaf_specs(params):
        tree[group][name] = torch.empty(shape, dtype=dtype, device="meta")
    return {**tree, "step": params["step"],
            "rng": torch.empty(2, dtype=torch.int64, device="meta")}


def state_bytes(params: dict) -> int:
    """Tensor bytes that one save of the whole state writes: every leaf's,
    over all ranks, and the rng pair once."""
    return sum(math.prod(s) * d.itemsize for _, _, s, d in leaf_specs(params)) + 16


def _generator_seed(seed: int, leaf: int, rank: int) -> int:
    return (seed * 1_000_003 + leaf * 64 + rank) % (1 << 63)


def draw(seed: int, leaf: int, rank: int, world: int, device: torch.device,
         params: dict) -> torch.Tensor:
    """Rank ``rank``'s shard of leaf ``leaf`` (``leaf_specs`` order) on
    ``device``, from its own generator."""
    group, name, shape, dtype = leaf_specs(params)[leaf]
    a, b = rows(shape[0], world, rank)
    local = (b - a, *shape[1:])
    gen = torch.Generator(device=device)
    gen.manual_seed(_generator_seed(seed, leaf, rank))

    def normal(std: float) -> torch.Tensor:
        return torch.randn(local, generator=gen, device=device, dtype=torch.float32).mul_(std)

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return torch.rand(local, generator=gen, device=device,
                          dtype=torch.float32).mul_(hi - lo).add_(lo)

    if group == "exp_avg":
        x = normal(params["moment_std"])
    elif group == "exp_avg_sq":
        x = normal(params["moment_std"]).square_()
    elif name.endswith(("norm.weight", ".D")):
        x = normal(params["norm_std"]).add_(1.0)
    elif name.endswith(".A_log"):
        x = uniform(1.0, 16.0).log_()
    elif name.endswith(".dt_bias"):
        dt = uniform(math.log(params["time_step_min"]), math.log(params["time_step_max"]))
        dt = dt.exp_().clamp_(min=params["time_step_floor"])
        x = dt + torch.log(-torch.expm1(-dt))
    else:
        x = normal(params["init_std"])
    return x.to(dtype)


def local_state(seed: int, rank: int, world: int, device: torch.device,
                params: dict) -> dict:
    """The state as rank ``rank`` of ``world`` holds it: every sharded
    leaf's local shard as a plain tensor."""
    tree = {group: {} for group, _ in GROUPS}
    for leaf, (group, name, _, _) in enumerate(leaf_specs(params)):
        tree[group][name] = draw(seed, leaf, rank, world, device, params)
    rng = torch.tensor([seed, seed + 1], dtype=torch.int64, device=device)
    return {**tree, "step": params["step"], "rng": rng}


def make(nbytes: int, seed: int, device: torch.device, params: dict, mesh) -> dict:
    """This process's state on ``device``: its shards as DTensors with
    ``Shard(0)`` over the one-dimensional device mesh ``mesh``, the step,
    and the rng pair as a plain tensor; ValueError unless the whole state
    holds ``nbytes`` tensor bytes."""
    from torch.distributed.tensor import DTensor, Shard

    want = state_bytes(params)
    if nbytes != want:
        raise ValueError(f"the state holds {want} tensor bytes, not {nbytes}")
    rank, world = mesh.get_local_rank(), mesh.size()
    state = local_state(seed, rank, world, device, params)
    for group, name, shape, _ in leaf_specs(params):
        state[group][name] = DTensor.from_local(
            state[group][name], mesh, [Shard(0)], run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    return state
