"""The port's HuggingFace import and export (`models/hf.py`) against the
JAX package's (`walkai_nos_tpu.models.hf`) and against `transformers`
itself.

Tiny HF models of both families, random from a torch seed (no
`from_pretrained`, nothing downloaded): GPT-2 (hidden 32, 2 layers, 2
heads, vocab 64, 32 positions, tied head) and llama (hidden 32, 2
layers, 4 heads over 4 or 2 kv heads, vocab 64, untied head).

- `config_from_*` give the JAX package's LMConfig field for field, and
  `params_from_*` its param tree bitwise;
- the imported model's no-cache logits equal HF's own in f32 within
  5e-4 absolute (the JAX test's bound: two implementations, f32,
  differing in summation order only; logits are O(0.1-1));
- greedy tokens equal `hf.generate`'s, through `make_generate_fn` and
  through the paged engine with staggered admission (seed 3, as in
  tests/test_hf.py: no near-argmax ties between the two f32
  implementations on any prompt; the engine equals `make_generate_fn`
  for any seed);
- the exports equal the JAX exports (config and state dict, bitwise),
  from the param tree and from a port `DecoderLM`, and an HF model
  loaded from the port's export gives the port's logits, also after two
  training steps of the port's `make_lm_train_step` (which untie the
  GPT-2 head);
- every rejection of the JAX tests, by message;
- the module imports with no `transformers`, and the config and param
  mappings work on a plain namespace and a dict of tensors.
"""

import dataclasses
import importlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from walkai_nos_tpu.models import hf as jhf  # noqa: E402
from walkai_nos_tpu_torch.models import hf  # noqa: E402
from walkai_nos_tpu_torch.models import lm as tlm  # noqa: E402
from walkai_nos_tpu_torch.models.convert import (  # noqa: E402
    flax_params_from_model,
    load_flax_params,
)
from walkai_nos_tpu_torch.models.decode import make_generate_fn  # noqa: E402
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher  # noqa: E402

torch.set_num_threads(1)

LOGIT_ATOL = 5e-4


def _gpt2(seed=0):
    torch.manual_seed(seed)
    cfg = transformers.GPT2Config(
        n_embd=32, n_layer=2, n_head=2, n_positions=32, vocab_size=64,
        attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0,
    )
    return transformers.GPT2LMHeadModel(cfg).eval()


def _llama(seed=0, kv_heads=2):
    torch.manual_seed(seed)
    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=kv_heads,
        intermediate_size=48, max_position_embeddings=64,
        rms_norm_eps=1e-6, attention_dropout=0.0,
        tie_word_embeddings=False,
    )
    return transformers.LlamaForCausalLM(cfg).eval()


# (name, HF model factory, port load_*, JAX load_*)
MODELS = {
    "gpt2": (_gpt2, hf.load_gpt2, jhf.load_gpt2),
    "llama-kv4": (lambda seed=0: _llama(seed, 4), hf.load_llama, jhf.load_llama),
    "llama-kv2": (_llama, hf.load_llama, jhf.load_llama),
}


def _leaves(tree, prefix=""):
    for name, sub in tree.items():
        if hasattr(sub, "items"):
            yield from _leaves(sub, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", np.asarray(sub)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for name, leaf in got.items():
        assert leaf.dtype == want[name].dtype, name
        np.testing.assert_array_equal(leaf, want[name], err_msg=name)


def _logits(cfg, params, tokens):
    model = tlm.DecoderLM.from_params(cfg, params, "cpu")
    with torch.no_grad():
        return model(torch.as_tensor(tokens)).numpy()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_import_matches_jax_and_hf(name):
    """Config field for field and params bitwise against the JAX import;
    logits against HF's model."""
    make, load, jload = MODELS[name]
    model = make()
    cfg, params = load(model)
    jcfg, jparams = jload(model)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_trees_equal(params, jparams)
    tokens = np.random.default_rng(0).integers(0, 64, (2, 16))
    with torch.no_grad():
        want = model(torch.tensor(tokens)).logits.numpy()
    assert np.max(np.abs(_logits(cfg, params, tokens) - want)) < LOGIT_ATOL


@pytest.mark.parametrize("name", ["gpt2", "llama-kv2"])
def test_greedy_generation_matches_hf(name):
    make, load, _ = MODELS[name]
    model = make(seed=3)
    cfg, params = load(model)
    prompt = np.random.default_rng(3).integers(0, 64, (1, 4))
    with torch.no_grad():
        want = model.generate(
            torch.tensor(prompt), max_new_tokens=6, do_sample=False,
            pad_token_id=0,
        ).numpy()[:, 4:]
    got = make_generate_fn(cfg, device="cpu")(params, prompt, 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["gpt2", "llama-kv2"])
def test_paged_engine_serves_an_imported_checkpoint(name):
    """The scenario of tests/test_hf.py's engine test: two requests join,
    the batch advances, two more join mid-flight into 2 slots; every
    request gets HF's greedy continuation and `make_generate_fn`'s."""
    make, load, _ = MODELS[name]
    model = make(seed=3)
    cfg, params = load(model)
    engine = ContinuousBatcher(cfg, params, slots=2, cache_len=32,
                               chunk_steps=2, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, n) for n in (4, 6, 3, 5)]
    rids = {engine.submit(p, max_new_tokens=6): p for p in prompts[:2]}
    engine.step()
    rids.update({engine.submit(p, max_new_tokens=6): p for p in prompts[2:]})
    out = engine.run()
    gen = make_generate_fn(cfg, device="cpu")
    for rid, p in rids.items():
        with torch.no_grad():
            want = model.generate(
                torch.tensor(p[None]), max_new_tokens=6, do_sample=False,
                pad_token_id=0,
            ).numpy()[0, len(p):]
        assert out[rid] == want.tolist(), rid
        assert out[rid] == gen(params, p[None], 6)[0].tolist(), rid


def _train_two_steps(cfg, params):
    """Two port AdamW steps from the imported weights; returns the
    trained f32-master DecoderLM."""
    state = tlm.init_lm_state(cfg, device="cpu", lr=1e-3)
    load_flax_params(state.params, params)
    step = tlm.make_lm_train_step(cfg, device="cpu", lr=1e-3)
    tokens = np.random.default_rng(2).integers(0, 64, (2, 16))
    for _ in range(2):
        state, _ = step(state, tokens)
    return state.params


@pytest.mark.parametrize("name", ["gpt2", "llama-kv2"])
@pytest.mark.parametrize("trained", [False, True])
def test_export_matches_jax_and_round_trips_through_hf(name, trained):
    make, load, _ = MODELS[name]
    cfg, params = load(make(seed=2))
    source = params
    if trained:
        source = _train_two_steps(cfg, params)
        tree = flax_params_from_model(source)
    else:
        tree = params
    export, jexport = (
        (hf.export_gpt2, jhf.export_gpt2) if name == "gpt2"
        else (hf.export_llama, jhf.export_llama)
    )
    for given in (tree, source):  # the tree, and a DecoderLM when trained
        config, sd = export(given, cfg)
        jconfig, jsd = jexport(tree, cfg)
        assert config.to_dict() == jconfig.to_dict()
        assert list(sd) == list(jsd)
        for key, value in sd.items():
            assert torch.equal(value, jsd[key]), key
    if name == "gpt2":
        # GPT-2 training unties the head, and the export says so.
        assert config.tie_word_embeddings is (not trained)
        assert hf.heads_are_tied(source) is (not trained)
    clone_cls = (transformers.GPT2LMHeadModel if name == "gpt2"
                 else transformers.LlamaForCausalLM)
    clone = clone_cls(config).eval()
    _, unexpected = clone.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    tokens = np.random.default_rng(3).integers(0, 64, (2, 12))
    with torch.no_grad():
        theirs = clone(torch.tensor(tokens)).logits.numpy()
    ours = _logits(cfg, source, tokens)
    assert np.max(np.abs(ours - theirs)) < LOGIT_ATOL


def test_state_dict_from_params_matches_jax():
    cfg, params = hf.load_gpt2(_gpt2())
    sd = hf.state_dict_from_params(params, cfg)
    jsd = jhf.state_dict_from_params(params, cfg)
    assert list(sd) == list(jsd)
    assert all(torch.equal(sd[k], jsd[k]) for k in sd)


def _rejections():
    """(what, call, message) for every refusal of the JAX tests, plus the
    silu, attention_bias and gpt2-export cases of the same checks."""

    def gpt2_config(**changes):
        c = _gpt2().config
        for k, v in changes.items():
            setattr(c, k, v)
        return c

    def llama_config(**changes):
        c = _llama().config
        for k, v in changes.items():
            setattr(c, k, v)
        return c

    def untied_gpt2():
        cfg, params = hf.load_gpt2(_gpt2())
        params["head"]["kernel"] = params["head"]["kernel"] + 0.1
        return params, cfg

    def head_bias_gpt2():
        cfg, params = hf.load_gpt2(_gpt2())
        params["head"]["bias"] = np.ones(cfg.vocab_size, np.float32)
        return params, cfg

    def gpt2_params():
        return hf.load_gpt2(_gpt2())[::-1]

    def llama_params():
        return hf.load_llama(_llama())[::-1]

    def moe(pair):
        params, cfg = pair
        return params, dataclasses.replace(cfg, num_experts=2)

    return {
        "gelu_new": (lambda: hf.config_from_gpt2(
            gpt2_config(activation_function="relu")), "gelu_new"),
        "n_inner": (lambda: hf.config_from_gpt2(gpt2_config(n_inner=100)),
                    "multiple of n_embd"),
        "rope_scaling": (lambda: hf.config_from_llama(llama_config(
            rope_scaling={"rope_type": "linear", "factor": 2.0})),
            "rope_scaling"),
        "mlp_bias": (lambda: hf.config_from_llama(llama_config(mlp_bias=True)),
                     "mlp_bias"),
        "attention_bias": (lambda: hf.config_from_llama(
            llama_config(attention_bias=True)), "attention_bias"),
        "silu": (lambda: hf.config_from_llama(llama_config(hidden_act="gelu")),
                 "silu"),
        "untied": (lambda: hf.state_dict_from_params(*untied_gpt2()), "untied"),
        "head_bias": (lambda: hf.state_dict_from_params(*head_bias_gpt2()),
                      "head_bias"),
        "gpt2_moe": (lambda: hf.state_dict_from_params(*moe(gpt2_params())),
                     "MoE"),
        "llama_moe": (lambda: hf.export_llama(*moe(llama_params())), "MoE"),
        "llama_export_of_gpt2": (lambda: hf.export_llama(*gpt2_params()),
                                 "llama-family"),
        "gpt2_export_of_llama": (lambda: hf.export_gpt2(*llama_params()),
                                 "GPT-2-family"),
    }


@pytest.mark.parametrize("what", sorted(_rejections()))
def test_rejections_match_jax(what):
    call, message = _rejections()[what]
    with pytest.raises(ValueError, match=message):
        call()


def test_quantized_model_export_is_refused():
    cfg, params = hf.load_llama(_llama())
    cfg8 = dataclasses.replace(cfg, w_dtype="int8")
    model = tlm.DecoderLM.from_params(
        cfg8, tlm.quantize_lm_params(params, cfg8), "cpu"
    )
    with pytest.raises(ValueError, match="w_dtype"):
        hf.export_llama(model, cfg8)


def test_imports_and_maps_without_transformers(monkeypatch):
    """No `transformers`: the module imports, `config_from_*` read any
    object with the HF attribute names, `params_from_*` take a dict of
    tensors, and only `load_*` by name and the exports need the
    package."""
    gpt2, llama = _gpt2(), _llama()
    want = {"gpt2": hf.load_gpt2(gpt2), "llama": hf.load_llama(llama)}
    sds = {"gpt2": dict(gpt2.state_dict()), "llama": dict(llama.state_dict())}
    namespaces = {
        name: SimpleNamespace(**m.config.to_dict())
        for name, m in (("gpt2", gpt2), ("llama", llama))
    }
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.delitem(sys.modules, "walkai_nos_tpu_torch.models.hf")
    bare = importlib.import_module("walkai_nos_tpu_torch.models.hf")
    for name in ("gpt2", "llama"):
        config_from = getattr(bare, f"config_from_{name}")
        params_from = getattr(bare, f"params_from_{name}")
        cfg = config_from(namespaces[name])
        assert cfg == want[name][0]
        _assert_trees_equal(params_from(sds[name], cfg), want[name][1])
    with pytest.raises(ImportError):
        bare.load_llama("some/checkpoint")
    with pytest.raises(ImportError):
        bare.export_gpt2(*want["gpt2"][::-1])
