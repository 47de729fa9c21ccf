"""HuggingFace checkpoint import and export (GPT-2 and llama families)
for the decoder LM.

Port of `walkai_nos_tpu/models/hf.py`, with its names and its checks.
The import side maps a `transformers` model, or only its config and
state dict, onto the flax-layout param tree the port's entry points take
(`DecoderLM.from_params`, `ContinuousBatcher`, `make_generate_fn`,
`models/convert.load_flax_params`): nested numpy arrays, f32.

GPT-2 family: pre-LN blocks, learned positions, fused qkv (HF `Conv1D`
stores kernels [in, out], the flax Dense orientation, so nothing is
transposed), gelu_new (the tanh gelu), an LM head tied to the token
embedding (wte^T).

Llama family: RMSNorm, rotary in HF's half-split layout, SwiGLU, grouped
query attention, no biases. The separate q/k/v/o `Linear` weights
([out, in]) transpose on import, and q/k/v concatenate into the fused
qkv kernel in the [q | k | v] channel order the model slices. A tied
checkpoint ships no `lm_head.weight` and takes the embedding^T as its
head.

`transformers` is imported only inside `load_*` (for a model name) and
the exports: `config_from_*` read the HF config's attribute names from
any object that has them, and `params_from_*` take any mapping from HF
names to tensors or arrays. The exports take the param tree or a port
`DecoderLM` (turned back into the tree by
`convert.flax_params_from_model`) and return (HF config, state dict of
torch tensors).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from walkai_nos_tpu_torch.models.convert import flax_params_from_model
from walkai_nos_tpu_torch.models.lm import DecoderLM, LMConfig

__all__ = [
    "config_from_gpt2",
    "config_from_llama",
    "export_gpt2",
    "export_llama",
    "heads_are_tied",
    "load_gpt2",
    "load_llama",
    "params_from_gpt2",
    "params_from_llama",
    "state_dict_from_params",
]


def config_from_gpt2(hf_config) -> LMConfig:
    """LMConfig mirroring a `transformers.GPT2Config`."""
    if getattr(hf_config, "activation_function", "gelu_new") != "gelu_new":
        raise ValueError(
            "only gelu_new GPT-2 variants map onto DecoderLM's gelu "
            f"(got {hf_config.activation_function})"
        )
    n_inner = getattr(hf_config, "n_inner", None) or 4 * hf_config.n_embd
    if n_inner % hf_config.n_embd != 0:
        raise ValueError(
            f"n_inner {n_inner} is not a multiple of n_embd "
            f"{hf_config.n_embd}; DecoderLM expresses the MLP width as "
            "an integer mlp_ratio"
        )
    return LMConfig(
        vocab_size=hf_config.vocab_size,
        hidden_dim=hf_config.n_embd,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        mlp_ratio=n_inner // hf_config.n_embd,
        max_seq_len=hf_config.n_positions,
        dtype="float32",
        layer_norm_eps=hf_config.layer_norm_epsilon,
        head_bias=False,  # GPT-2's lm_head is bias-free
    )


def _np(tensor) -> np.ndarray:
    """A tensor (any float dtype, any device) or array as f32 numpy."""
    if isinstance(tensor, torch.Tensor):
        tensor = tensor.detach().cpu().float().numpy()
    return np.asarray(tensor, dtype=np.float32)


def params_from_gpt2(state_dict: Mapping, cfg: LMConfig) -> dict:
    """DecoderLM params tree from a GPT2LMHeadModel state dict."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}

    def ln(prefix: str) -> dict:
        return {
            "scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"]),
        }

    def dense(prefix: str) -> dict:
        # Conv1D kernels are [in, out], as flax Dense's: no transpose.
        return {
            "kernel": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"]),
        }

    wte = _np(sd["wte.weight"])  # [vocab, hidden]
    params: dict = {
        "embed": {"embedding": wte},
        "pos_embed": _np(sd["wpe.weight"])[None],
        "norm": ln("ln_f"),
        # Tied at import; training may untie it (head_bias=False keeps
        # the model exportable).
        "head": {"kernel": np.ascontiguousarray(wte.T)},
    }
    for i in range(cfg.num_layers):
        h = f"h.{i}"
        params[f"block{i}"] = {
            "norm1": ln(f"{h}.ln_1"),
            "attn": {
                "qkv": dense(f"{h}.attn.c_attn"),
                "out_proj": dense(f"{h}.attn.c_proj"),
            },
            "norm2": ln(f"{h}.ln_2"),
            "fc1": dense(f"{h}.mlp.c_fc"),
            "fc2": dense(f"{h}.mlp.c_proj"),
        }
    return params


def load_gpt2(model_or_name) -> tuple[LMConfig, dict]:
    """(LMConfig, params) from a GPT2LMHeadModel instance, or from a model
    name for `from_pretrained` (the weights on disk or a network)."""
    if isinstance(model_or_name, str):
        from transformers import GPT2LMHeadModel

        model_or_name = GPT2LMHeadModel.from_pretrained(model_or_name)
    cfg = config_from_gpt2(model_or_name.config)
    return cfg, params_from_gpt2(model_or_name.state_dict(), cfg)


def config_from_llama(hf_config) -> LMConfig:
    """LMConfig mirroring a `transformers.LlamaConfig`."""
    if getattr(hf_config, "rope_scaling", None) is not None:
        raise ValueError(
            "rope_scaling variants (linear/dynamic/yarn) are not "
            "supported; only default rotary embeddings map onto "
            "DecoderLM's apply_rope"
        )
    if getattr(hf_config, "attention_bias", False) or getattr(
        hf_config, "mlp_bias", False
    ):
        raise ValueError(
            "attention_bias/mlp_bias llama variants are not supported: "
            "DecoderLM expresses the llama family bias-free "
            "(use_bias=False); importing would silently drop the biases"
        )
    if getattr(hf_config, "hidden_act", "silu") != "silu":
        raise ValueError(
            f"only silu llama variants map onto DecoderLM's swiglu "
            f"(got {hf_config.hidden_act})"
        )
    return LMConfig(
        vocab_size=hf_config.vocab_size,
        hidden_dim=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=hf_config.num_key_value_heads,
        mlp_dim=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        dtype="float32",
        layer_norm_eps=hf_config.rms_norm_eps,
        norm="rmsnorm",
        mlp="swiglu",
        rope=True,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        use_bias=False,
        head_bias=False,
    )


def params_from_llama(state_dict: Mapping, cfg: LMConfig) -> dict:
    """DecoderLM params tree from a LlamaForCausalLM state dict."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}

    def linear(prefix: str) -> np.ndarray:
        # Linear weights are [out, in]; flax Dense kernels [in, out].
        return np.ascontiguousarray(_np(sd[f"{prefix}.weight"]).T)

    embed = _np(sd["embed_tokens.weight"])  # [vocab, hidden]
    if "lm_head.weight" in state_dict:
        head = np.ascontiguousarray(_np(state_dict["lm_head.weight"]).T)
    else:  # tie_word_embeddings checkpoints ship no separate head
        head = np.ascontiguousarray(embed.T)
    params: dict = {
        "embed": {"embedding": embed},
        "norm": {"scale": _np(sd["norm.weight"])},
        "head": {"kernel": head},
    }
    for i in range(cfg.num_layers):
        h = f"layers.{i}"
        qkv = np.concatenate(
            [linear(f"{h}.self_attn.{n}_proj") for n in "qkv"], axis=1
        )  # [hidden, d + 2 * kv_dim]: the fused [q | k | v] layout
        params[f"block{i}"] = {
            "norm1": {"scale": _np(sd[f"{h}.input_layernorm.weight"])},
            "attn": {
                "qkv": {"kernel": qkv},
                "out_proj": {"kernel": linear(f"{h}.self_attn.o_proj")},
            },
            "norm2": {
                "scale": _np(sd[f"{h}.post_attention_layernorm.weight"])
            },
            "gate": {"kernel": linear(f"{h}.mlp.gate_proj")},
            "fc1": {"kernel": linear(f"{h}.mlp.up_proj")},
            "fc2": {"kernel": linear(f"{h}.mlp.down_proj")},
        }
    return params


def load_llama(model_or_name) -> tuple[LMConfig, dict]:
    """(LMConfig, params) from a LlamaForCausalLM instance or name."""
    if isinstance(model_or_name, str):
        from transformers import LlamaForCausalLM

        model_or_name = LlamaForCausalLM.from_pretrained(model_or_name)
    cfg = config_from_llama(model_or_name.config)
    return cfg, params_from_llama(model_or_name.state_dict(), cfg)


def _tree(params) -> Mapping:
    """The param tree of `params`: a tree as it is, or a port DecoderLM's
    parameters (a full-precision build: an int8 kernel has no HF
    counterpart)."""
    if isinstance(params, DecoderLM):
        if params.cfg.w_quant:
            raise ValueError(
                f"w_dtype={params.cfg.w_dtype!r} weights have no HF "
                f"counterpart; export a full-precision (w_dtype='model') "
                f"DecoderLM"
            )
        return flax_params_from_model(params)
    return params


def _tensor(x, transpose: bool = False) -> torch.Tensor:
    arr = np.array(x, np.float32)
    return torch.from_numpy(arr.T.copy() if transpose else arr)


def export_llama(params, cfg: LMConfig):
    """(LlamaConfig, state_dict): back to torch. The config mirrors
    `config_from_llama`'s mapping; `tie_word_embeddings` is set from the
    params' actual tie state (as `export_gpt2` does)."""
    from transformers import LlamaConfig

    if cfg.num_experts > 0:
        raise ValueError(
            "MoE blocks have no llama analogue; export a dense "
            "(num_experts=0) DecoderLM"
        )
    if cfg.norm != "rmsnorm" or cfg.mlp != "swiglu" or not cfg.rope:
        raise ValueError(
            "not a llama-family config (needs rmsnorm/swiglu/rope); "
            "use export_gpt2 for GPT-2-family models"
        )
    params = _tree(params)
    config = LlamaConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_dim,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.kv_heads,
        intermediate_size=cfg.mlp_width,
        max_position_embeddings=cfg.max_seq_len,
        rms_norm_eps=cfg.layer_norm_eps,
        rope_theta=cfg.rope_theta,
        attention_bias=False,
        tie_word_embeddings=heads_are_tied(params),
    )
    d = cfg.hidden_dim
    kv_dim = cfg.kv_heads * cfg.head_dim
    sd = {
        "model.embed_tokens.weight": _tensor(params["embed"]["embedding"]),
        "model.norm.weight": _tensor(params["norm"]["scale"]),
        "lm_head.weight": _tensor(params["head"]["kernel"], True),
    }
    for i in range(cfg.num_layers):
        block = params[f"block{i}"]
        h = f"model.layers.{i}"
        qkv = np.asarray(block["attn"]["qkv"]["kernel"], np.float32)
        sd[f"{h}.self_attn.q_proj.weight"] = _tensor(qkv[:, :d], True)
        sd[f"{h}.self_attn.k_proj.weight"] = _tensor(qkv[:, d:d + kv_dim], True)
        sd[f"{h}.self_attn.v_proj.weight"] = _tensor(qkv[:, d + kv_dim:], True)
        sd[f"{h}.self_attn.o_proj.weight"] = _tensor(
            block["attn"]["out_proj"]["kernel"], True
        )
        sd[f"{h}.input_layernorm.weight"] = _tensor(block["norm1"]["scale"])
        sd[f"{h}.post_attention_layernorm.weight"] = _tensor(
            block["norm2"]["scale"]
        )
        sd[f"{h}.mlp.gate_proj.weight"] = _tensor(block["gate"]["kernel"], True)
        sd[f"{h}.mlp.up_proj.weight"] = _tensor(block["fc1"]["kernel"], True)
        sd[f"{h}.mlp.down_proj.weight"] = _tensor(block["fc2"]["kernel"], True)
    return config, sd


def heads_are_tied(params, atol: float = 1e-5) -> bool:
    """True when the LM head still equals the token embedding (wte^T)."""
    params = _tree(params)
    return bool(np.allclose(
        np.asarray(params["head"]["kernel"], np.float32),
        np.asarray(params["embed"]["embedding"], np.float32).T,
        atol=atol,
    ))


def export_gpt2(params, cfg: LMConfig):
    """(GPT2Config, state_dict): the safe export entry point.

    The config's `tie_word_embeddings` matches the actual tie state of
    `params`, so `GPT2LMHeadModel(config)` + `load_state_dict(sd,
    strict=False)` is always faithful: an untied head loaded into a TIED
    model would silently overwrite the token embedding (HF shares the
    tensor; the last copy wins)."""
    from transformers import GPT2Config

    params = _tree(params)
    tied = heads_are_tied(params)
    config = GPT2Config(
        vocab_size=cfg.vocab_size,
        n_embd=cfg.hidden_dim,
        n_layer=cfg.num_layers,
        n_head=cfg.num_heads,
        n_inner=cfg.mlp_ratio * cfg.hidden_dim,
        n_positions=cfg.max_seq_len,
        layer_norm_epsilon=cfg.layer_norm_eps,
        activation_function="gelu_new",
        tie_word_embeddings=tied,
    )
    # The config already encodes the tie verdict, so the export is
    # faithful either way: untied_ok=True skips the re-check.
    return config, state_dict_from_params(params, cfg, untied_ok=True)


def state_dict_from_params(
    params, cfg: LMConfig, *, untied_ok: bool = False
) -> dict:
    """The reverse mapping: DecoderLM params (a tree or a port DecoderLM)
    -> a GPT2LMHeadModel state dict of torch tensors.

    Training unties the head from the embedding; an untied export is
    only faithful when loaded into a GPT2LMHeadModel built with
    tie_word_embeddings=False. Pass `untied_ok=True` to acknowledge
    that, or use `export_gpt2`, which builds the matching config. GPT-2's
    lm_head is bias-free (import with head_bias=False, as
    `config_from_gpt2` does), and a dense-MLP model is required (MoE has
    no GPT-2 analogue)."""
    if cfg.norm != "layernorm" or cfg.mlp != "gelu" or cfg.rope:
        raise ValueError(
            "not a GPT-2-family config (rmsnorm/swiglu/rope); use "
            "export_llama for llama-family models"
        )
    params = _tree(params)
    if not untied_ok and not heads_are_tied(params):
        raise ValueError(
            "the LM head has untied from the token embedding (training "
            "does this); loading the export into a default tied "
            "GPT2LMHeadModel would silently overwrite the embedding — "
            "use export_gpt2() for a matching config, or pass "
            "untied_ok=True"
        )
    if cfg.num_experts > 0:
        raise ValueError(
            "MoE blocks have no GPT-2 analogue; export a dense "
            "(num_experts=0) DecoderLM"
        )
    head = params["head"]
    bias = np.asarray(head.get("bias", 0.0), np.float32)
    if np.max(np.abs(bias), initial=0.0) > 1e-6:
        raise ValueError(
            "GPT-2 has no LM-head bias; train with head_bias=False "
            "(config_from_gpt2 imports that way) to keep the model "
            "exportable"
        )
    sd = {
        "transformer.wte.weight": _tensor(params["embed"]["embedding"]),
        "transformer.wpe.weight": _tensor(params["pos_embed"][0]),
        "transformer.ln_f.weight": _tensor(params["norm"]["scale"]),
        "transformer.ln_f.bias": _tensor(params["norm"]["bias"]),
        "lm_head.weight": _tensor(head["kernel"], True),
    }
    for i in range(cfg.num_layers):
        block = params[f"block{i}"]
        h = f"transformer.h.{i}"
        for name, leaf in (
            ("ln_1", block["norm1"]), ("attn.c_attn", block["attn"]["qkv"]),
            ("attn.c_proj", block["attn"]["out_proj"]),
            ("ln_2", block["norm2"]), ("mlp.c_fc", block["fc1"]),
            ("mlp.c_proj", block["fc2"]),
        ):
            weight = leaf["scale"] if name.startswith("ln") else leaf["kernel"]
            sd[f"{h}.{name}.weight"] = _tensor(weight)
            sd[f"{h}.{name}.bias"] = _tensor(leaf["bias"])
    return sd
