"""The port's LoRA registry (`walkai_nos_tpu_torch/models/lora.py`) and
adapter npz files against the JAX package's, on the CPU.

No engine runs here: `lora_delta` is held to JAX's at atol = rtol =
1e-5 (two f32 products, summed in other orders); everything else is
exact. `AdapterSet` must build, load (ragged ranks padded, alpha folded
into B), unload and register the same host arrays bit for bit, with the
same errors; `adapter_tag` the same bytes; `tree_crc32`, and so
`digests()`, the same integers; and an adapter written by either
package's `save_lora_adapter` must load in the other's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import checkpoint as jckpt
from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models import lora as jlora
from walkai_nos_tpu.obs.capture import tree_crc32 as jax_tree_crc32
from walkai_nos_tpu_torch.models import checkpoint as tckpt
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models import lora as tlora

# tests/test_serve_lora.py's CFG, a swiglu GQA llama and an MoE model.
CONFIGS = {
    "gelu": dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=2,
                 max_seq_len=512, dtype="float32"),
    "swiglu_gqa": dict(vocab_size=64, hidden_dim=64, num_layers=3,
                       num_heads=4, num_kv_heads=2, mlp_dim=96,
                       max_seq_len=256, dtype="float32", norm="rmsnorm",
                       mlp="swiglu", rope=True, use_bias=False,
                       head_bias=False),
    "moe": dict(vocab_size=64, hidden_dim=64, num_layers=3, num_heads=4,
                num_kv_heads=2, mlp_dim=96, max_seq_len=256,
                dtype="float32", norm="rmsnorm", mlp="swiglu", rope=True,
                use_bias=False, head_bias=False, num_experts=4,
                moe_every=2, expert_top_k=2),
}


def _cfgs(name):
    return jlm.LMConfig(**CONFIGS[name]), tlm.LMConfig(**CONFIGS[name])


def _tree(cfg_name, seed, *, rank=2, blocks=(0,), projs=("qkv", "fc2")):
    """A partial adapter tree of rank `rank` (missing entries identity)."""
    dims = tlora.lora_proj_dims(tlm.LMConfig(**CONFIGS[cfg_name]))
    rng = np.random.default_rng(seed)
    return {
        f"block{i}": {
            p: {"a": rng.standard_normal((dims[p][0], rank), np.float32),
                "b": rng.standard_normal((rank, dims[p][1]), np.float32)}
            for p in projs
        }
        for i in blocks
    }


def _assert_same_sets(jset, tset):
    jh, th = jset.host_tree(), tset.host_tree()
    assert sorted(jh) == sorted(th)
    for blk in jh:
        assert sorted(jh[blk]) == sorted(th[blk])
        for proj in jh[blk]:
            for name in ("lora_a", "lora_b"):
                j, t = jh[blk][proj][name], th[blk][proj][name]
                assert j.dtype == t.dtype and j.shape == t.shape
                assert np.array_equal(j, t), (blk, proj, name)
    assert tset.resident() == jset.resident()
    assert tset.digests() == jset.digests()
    assert tset.fingerprint() == jset.fingerprint()


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_proj_dims_and_compatibility_match_jax(cfg_name):
    jcfg, tcfg = _cfgs(cfg_name)
    assert tlora.lora_proj_dims(tcfg) == jlora.lora_proj_dims(jcfg)
    tset = tlora.AdapterSet(tcfg)
    assert tset.compatible(tcfg)
    for other in sorted(CONFIGS):
        _, ocfg = _cfgs(other)
        assert tset.compatible(ocfg) == jlora.AdapterSet(jcfg).compatible(
            jlm.LMConfig(**CONFIGS[other]))


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("k, rank, scale", [(4, 4, 0.5), (3, 8, 0.02), (2, 1, 1.0)])
def test_synthetic_sets_are_jax_arrays(cfg_name, k, rank, scale):
    """Ragged ranks (adapter i has rank 1 + (i - 1) % rank), padded to the
    bucket, unit alpha folded; digests and recipe equal."""
    jcfg, tcfg = _cfgs(cfg_name)
    jset = jlora.AdapterSet.synthetic(jcfg, k=k, rank=rank, seed=3, scale=scale)
    tset = tlora.AdapterSet.synthetic(tcfg, k=k, rank=rank, seed=3, scale=scale)
    _assert_same_sets(jset, tset)
    assert len(tset.digests()) == k - 1


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_load_unload_register_match_jax(cfg_name):
    """A reload with alpha over a ragged rank, a load with the default
    alpha, an unload, then `register` into the lowest free id: the same
    arrays, residents and digests after every step."""
    jcfg, tcfg = _cfgs(cfg_name)
    jset = jlora.AdapterSet.synthetic(jcfg, k=4, rank=4, seed=0, scale=0.5)
    tset = tlora.AdapterSet.synthetic(tcfg, k=4, rank=4, seed=0, scale=0.5)
    steps = [
        ("load", 2, _tree(cfg_name, 1, rank=3, blocks=(0, 1)), dict(name="x", alpha=8.0)),
        ("load", 3, _tree(cfg_name, 2, rank=1, projs=("out_proj", "fc1")),
         dict(name="y")),
        ("unload", 1, None, {}),
        ("register", None, _tree(cfg_name, 4, rank=4, blocks=(1,)),
         dict(name="z", alpha=2.0)),
    ]
    for op, aid, tree, kw in steps:
        for aset in (jset, tset):
            if op == "load":
                aset.load(aid, tree, **kw)
            elif op == "unload":
                aset.unload(aid)
            else:
                assert aset.register(kw["name"], tree, alpha=kw["alpha"]) == 1
        _assert_same_sets(jset, tset)


def _errors():
    d = 32
    ok = {"a": np.zeros((d, 2), np.float32), "b": np.zeros((2, 3 * d), np.float32)}
    return {
        "capacity": (lambda m: m.AdapterSet(_cfg(m), capacity=1)),
        "rank": (lambda m: m.AdapterSet(_cfg(m), rank=0)),
        "load_id_0": (lambda m: m.AdapterSet(_cfg(m)).load(0, {}, name="x")),
        "load_id_capacity": (lambda m: m.AdapterSet(_cfg(m)).load(4, {}, name="x")),
        "unknown_block": (lambda m: m.AdapterSet(_cfg(m)).load(
            1, {"block9": {"qkv": ok}}, name="x")),
        "unknown_proj": (lambda m: m.AdapterSet(_cfg(m)).load(
            1, {"block0": {"gate": ok}}, name="x")),
        "shape": (lambda m: m.AdapterSet(_cfg(m)).load(
            1, {"block0": {"out_proj": ok}}, name="x")),
        "rank_bucket": (lambda m: m.AdapterSet(_cfg(m), rank=1).load(
            1, {"block0": {"qkv": ok}}, name="x")),
        "unload_base": (lambda m: m.AdapterSet(_cfg(m)).unload(0)),
        "unload_absent": (lambda m: m.AdapterSet(_cfg(m)).unload(2)),
        "full": (lambda m: m.AdapterSet.synthetic(_cfg(m), k=2).register("x", {})),
    }


def _cfg(mod):
    lm = jlm if mod is jlora else tlm
    return lm.LMConfig(**CONFIGS["gelu"])


@pytest.mark.parametrize("case", sorted(_errors()))
def test_rejections_match_jax(case):
    """Each bad call raises ValueError with JAX's message."""
    make = _errors()[case]
    msgs = []
    for mod in (jlora, tlora):
        with pytest.raises(ValueError) as err:
            make(mod)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_bad_load_leaves_the_slot_untouched():
    tcfg = tlm.LMConfig(**CONFIGS["gelu"])
    tset = tlora.AdapterSet.synthetic(tcfg, k=3, rank=2, scale=0.5)
    before = tset.digests()
    bad = _tree("gelu", 9)
    bad["block1"] = {"qkv": {"a": np.zeros((3, 2)), "b": np.zeros((2, 96))}}
    with pytest.raises(ValueError, match="do not factor"):
        tset.load(1, bad, name="bad")
    assert tset.digests() == before
    assert tset.resident()["1"]["name"] == "synthetic-1"


@pytest.mark.parametrize("adapter", [0, 1, 3, 127, 2**31 - 1])
def test_adapter_tag_bytes(adapter):
    assert tlora.adapter_tag(adapter) == jlora.adapter_tag(adapter)
    assert len({tlora.adapter_tag(k) for k in range(4)}) == 4


@pytest.mark.parametrize("tree", [
    {"b": {"y": np.arange(6, dtype=np.float32).reshape(2, 3),
           "x": np.int8([1, -2])},
     "a": [np.float16([1.5]), {"z": np.zeros((0, 4), np.int32)}]},
    {"block0": {"qkv": {"lora_a": np.ones((4, 2), np.float32),
                        "lora_b": np.full((2, 12), 0.5, np.float32)}},
     "block10": {}, "block2": {"fc1": {"lora_a": np.eye(3, dtype=np.float32)}}},
], ids=["mixed", "lora_like"])
def test_tree_crc32_matches_jax(tree):
    """Leaf paths as `jax.tree_util.keystr` writes them, sorted, each with
    its dtype, shape and bytes; tensors read as their numpy arrays."""
    def tensors(t):
        if isinstance(t, dict):
            return {k: tensors(v) for k, v in t.items()}
        if isinstance(t, list):
            return [tensors(v) for v in t]
        return torch.from_numpy(t)

    want = jax_tree_crc32(tree)
    assert tlora.tree_crc32(tree) == want
    assert tlora.tree_crc32(tensors(tree)) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("steps", [1, 5, 32])
def test_lora_delta_matches_jax(dtype, steps):
    """`(x @ A[ids]) @ B[ids]` in f32 whatever x's dtype, rows picking
    their own adapters (ids repeat and include 0)."""
    rng = np.random.default_rng(steps)
    k, b, din, r, dout = 4, 6, 48, 4, 80
    x = rng.standard_normal((b, steps, din)).astype(np.float32)
    a = rng.standard_normal((k, din, r)).astype(np.float32)
    bb = rng.standard_normal((k, r, dout)).astype(np.float32)
    ids = np.array([0, 3, 1, 3, 2, 0], np.int32)
    xt = torch.from_numpy(x).to(dtype)
    got = tlora.lora_delta(
        xt, {"lora_a": torch.from_numpy(a), "lora_b": torch.from_numpy(bb)},
        torch.from_numpy(ids).long())
    want = np.asarray(jlora.lora_delta(
        jnp.asarray(xt.float().numpy()),
        {"lora_a": jnp.asarray(a), "lora_b": jnp.asarray(bb)}, jnp.asarray(ids)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("alpha", [None, 8.0])
def test_npz_loads_across_packages(tmp_path, writer, alpha):
    """A file from either package's `save_lora_adapter` reads back in the
    other's as the same (tree, name, alpha); loaded into an AdapterSet it
    gives the digests of the tree loaded directly."""
    tree = _tree("gelu", 5, blocks=(0, 1), projs=("qkv", "fc2"))
    save, load = ((jckpt.save_lora_adapter, tckpt.load_lora_adapter)
                  if writer == "jax" else
                  (tckpt.save_lora_adapter, jckpt.load_lora_adapter))
    path = tmp_path / "sub" / "adapter.npz"
    save(path, tree, name="tuned", alpha=alpha)
    loaded, name, got_alpha = load(path)
    assert (name, got_alpha) == ("tuned", alpha)
    assert sorted(loaded) == sorted(tree)
    for blk in tree:
        for proj in tree[blk]:
            for ab in ("a", "b"):
                assert np.array_equal(loaded[blk][proj][ab], tree[blk][proj][ab])
    tcfg = tlm.LMConfig(**CONFIGS["gelu"])
    direct, reloaded = tlora.AdapterSet(tcfg), tlora.AdapterSet(tcfg)
    direct.load(1, tree, name="tuned", alpha=alpha)
    reloaded.load(1, loaded, name=name, alpha=got_alpha)
    jset = jlora.AdapterSet(jlm.LMConfig(**CONFIGS["gelu"]))
    jset.load(1, tree, name="tuned", alpha=alpha)
    assert direct.digests() == reloaded.digests() == jset.digests()
    assert direct.resident() == reloaded.resident() == jset.resident()
