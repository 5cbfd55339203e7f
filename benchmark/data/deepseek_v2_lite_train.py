"""A DeepSeek-V2-Lite training job's state on one rank: fp32 master weights, bf16 Adam moments, a step and an rng pair.

The rank is pipeline stage 0 of stages of ``num_hidden_layers`` layers and
one rank of ``expert_parallel``-way expert parallelism: the embedding, the
first ``first_k_dense_replace`` layers dense, the rest mixture-of-experts
layers holding ``n_routed_experts`` experts each (experts 0 to
``n_routed_experts - 1``).  The parameters carry the Hugging Face
DeepSeek-V2 names (``model.embed_tokens.weight``,
``model.layers.<i>.self_attn.q_proj.weight``, ...) and the shapes of the
public config's widths (``params`` is the configuration file):

- attention with no q_lora: ``q_proj`` (heads x (qk_nope + qk_rope),
  hidden), ``kv_a_proj_with_mqa`` (kv_lora_rank + qk_rope, hidden),
  ``kv_a_layernorm`` (kv_lora_rank,), ``kv_b_proj`` (heads x (qk_nope +
  v_head), kv_lora_rank), ``o_proj`` (hidden, heads x v_head);
- a dense MLP: ``gate_proj`` / ``up_proj`` (intermediate, hidden),
  ``down_proj`` (hidden, intermediate);
- an MoE layer: ``experts.<j>`` MLPs of ``moe_intermediate_size``, the
  router ``gate`` (n_routed_experts_published, hidden), whose width stays
  the published count of experts, and ``shared_experts``, one MLP of
  n_shared_experts x moe_intermediate_size;
- ``input_layernorm`` and ``post_attention_layernorm`` (hidden,).

At the published widths that is 151 tensors of 692,345,344 values.  The
state is ``{"master": {name: fp32}, "exp_avg": {name: bf16}, "exp_avg_sq":
{name: bf16}, "step": step, "rng": int64 [seed, seed + 1]}``: 454 tensor
leaves of 5,538,762,768 bytes.  Every value is drawn on the device from
the seed: master N(0, init_std), RMSNorm weights 1 + N(0, norm_std),
``exp_avg`` N(0, moment_std), ``exp_avg_sq`` the square of an N(0,
moment_std) draw, each drawn in float32 and rounded to its dtype.
"""

from __future__ import annotations

import torch

GROUPS = (("master", torch.float32), ("exp_avg", torch.bfloat16),
          ("exp_avg_sq", torch.bfloat16))


def _mlp(prefix: str, hidden: int, width: int) -> dict:
    return {f"{prefix}.gate_proj.weight": (width, hidden),
            f"{prefix}.up_proj.weight": (width, hidden),
            f"{prefix}.down_proj.weight": (hidden, width)}


def parameter_shapes(params: dict) -> dict:
    """{parameter name: shape}, in the Hugging Face module order."""
    h, heads = params["hidden_size"], params["num_attention_heads"]
    nope, rope = params["qk_nope_head_dim"], params["qk_rope_head_dim"]
    v, rank = params["v_head_dim"], params["kv_lora_rank"]
    out = {"model.embed_tokens.weight": (params["vocab_size"], h)}
    for i in range(params["num_hidden_layers"]):
        p = f"model.layers.{i}"
        out.update({f"{p}.self_attn.q_proj.weight": (heads * (nope + rope), h),
                    f"{p}.self_attn.kv_a_proj_with_mqa.weight": (rank + rope, h),
                    f"{p}.self_attn.kv_a_layernorm.weight": (rank,),
                    f"{p}.self_attn.kv_b_proj.weight": (heads * (nope + v), rank),
                    f"{p}.self_attn.o_proj.weight": (h, heads * v)})
        if i < params["first_k_dense_replace"]:
            out.update(_mlp(f"{p}.mlp", h, params["intermediate_size"]))
        else:
            width = params["moe_intermediate_size"]
            for j in range(params["n_routed_experts"]):
                out.update(_mlp(f"{p}.mlp.experts.{j}", h, width))
            out[f"{p}.mlp.gate.weight"] = (params["n_routed_experts_published"], h)
            out.update(_mlp(f"{p}.mlp.shared_experts", h,
                            params["n_shared_experts"] * width))
        out[f"{p}.input_layernorm.weight"] = (h,)
        out[f"{p}.post_attention_layernorm.weight"] = (h,)
    return out


def shapes(params: dict) -> dict:
    """The state's tree with every tensor leaf on the meta device (its
    shape and dtype; nothing is allocated) and the step in its place."""
    names = parameter_shapes(params)
    tree = {group: {n: torch.empty(s, dtype=dtype, device="meta") for n, s in names.items()}
            for group, dtype in GROUPS}
    return {**tree, "step": params["step"],
            "rng": torch.empty(2, dtype=torch.int64, device="meta")}


def state_bytes(params: dict) -> int:
    """Tensor bytes of the whole state."""
    tree = shapes(params)
    return sum(t.nbytes for g, _ in GROUPS for t in tree[g].values()) + tree["rng"].nbytes


def make(nbytes: int, seed: int, device: torch.device, params: dict) -> dict:
    """The state on ``device`` from ``seed``; ValueError unless it holds
    ``nbytes`` tensor bytes."""
    want = state_bytes(params)
    if nbytes != want:
        raise ValueError(f"the state holds {want} tensor bytes, not {nbytes}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(shape, std: float) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(std)

    names = parameter_shapes(params)
    master, exp_avg, exp_avg_sq = {}, {}, {}
    for name, shape in names.items():
        if name.endswith("layernorm.weight"):
            master[name] = draw(shape, params["norm_std"]).add_(1.0)
        else:
            master[name] = draw(shape, params["init_std"])
    for name, shape in names.items():
        exp_avg[name] = draw(shape, params["moment_std"]).to(torch.bfloat16)
    for name, shape in names.items():
        exp_avg_sq[name] = draw(shape, params["moment_std"]).square_().to(torch.bfloat16)
    rng = torch.tensor([seed, seed + 1], dtype=torch.int64, device=device)
    return {"master": master, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq,
            "step": params["step"], "rng": rng}
