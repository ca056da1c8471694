"""The port's model modules against the JAX reference on the CPU, with the
same numpy inputs and the same weights (carried across by from_jax_params).

Tolerances: 1e-5 on the primitives, 1e-4 on attention outputs and logits
(fp32 throughout; the frameworks sum in different orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced_config as jax_reduced
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtf
from repro.models.model_zoo import build_model as jax_build
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.convert import from_jax_params
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttf
from repro_torch.models.model_zoo import build_model

torch.set_num_threads(1)

PRIM_ATOL = 1e-5
LOGIT_ATOL = 1e-4


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


def lm_pair(name, seed=0):
    """(jax cfg, port cfg, jax params, port DecoderLM) with equal weights.
    The norm weights start at zero in both; they get random values here so
    the (1 + w) scaling is exercised."""
    cfg_j, cfg_t = jax_reduced(name), reduced_config(name)
    tree = jax.tree.map(np.asarray, jax_build(cfg_j).init(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        last = path[-1].key
        if last.startswith("ln_") or last in ("q_norm", "k_norm",
                                              "final_norm"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    params = jax.tree.map(jnp.asarray, tree)
    return cfg_j, cfg_t, params, from_jax_params(cfg_t, tree, device="cpu")


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------- #
# configs
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_model_config_fields_match_jax(name, reduced):
    cj = jax_reduced(name) if reduced else JAX_ARCHS[name]
    ct = reduced_config(name) if reduced else get_config(name)
    fj = {f.name: getattr(cj, f.name) for f in dataclasses.fields(cj)}
    ft = {f.name: getattr(ct, f.name) for f in dataclasses.fields(ct)}
    assert str(jnp.dtype(fj.pop("dtype"))) == str(ft.pop("dtype")).split(".")[1]
    assert fj == ft
    assert (cj.hd, cj.q_groups, cj.param_count(), cj.active_param_count()) \
        == (ct.hd, ct.q_groups, ct.param_count(), ct.active_param_count())
    assert sorted(ARCHS) == sorted(JAX_ARCHS)


# ---------------------------------------------------------------------- #
# primitives
# ---------------------------------------------------------------------- #

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x, w = normal(rng, 3, 5, 64), 0.1 * normal(rng, 64)
    close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
          jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w)), PRIM_ATOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax_at_long_positions(theta):
    rng = np.random.default_rng(2)
    x = normal(rng, 2, 64, 4, 128)
    pos = np.sort(rng.choice(4097, 64, replace=False)).astype(np.int32)
    pos[-1] = 4096
    close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
          jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
          PRIM_ATOL)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("variant", ["gated", "plain"])
def test_mlp_forward_matches_jax(activation, variant):
    rng = np.random.default_rng(3)
    pj = jax.tree.map(np.asarray, jmlp.init_mlp(
        jax.random.PRNGKey(0), 64, 128, variant=variant))
    pt = tmlp.MLP(64, 128, variant=variant)
    with torch.no_grad():
        for name, w in pj.items():
            getattr(pt, name).weight.copy_(torch.tensor(w.T))
    x = normal(rng, 2, 7, 64)
    close(tmlp.mlp_forward(pt, torch.from_numpy(x), activation),
          jmlp.mlp_forward(jax.tree.map(jnp.asarray, pj), jnp.asarray(x),
                           activation), PRIM_ATOL)


# ---------------------------------------------------------------------- #
# attention
# ---------------------------------------------------------------------- #

SPECS = [jattn.MaskSpec(causal=True), jattn.MaskSpec(causal=True, window=8),
         jattn.MaskSpec(causal=True, prefix_len=5), jattn.MaskSpec(False)]


def _tspec(spec):
    return tattn.MaskSpec(spec.causal, spec.window, spec.prefix_len)


@pytest.mark.parametrize("name", ["qwen3-8b", "gemma2-2b"])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("offset", [None, 5])
def test_attention_forward_no_cache_matches_jax(name, spec, offset):
    """offset None: positions 0..S-1 passed as None to the port; 5: explicit
    positions 5..S+4 on both sides."""
    cfg_j, cfg_t, pj, pt = lm_pair(name)
    rng = np.random.default_rng(4)
    s = 24
    x = normal(rng, 2, s, cfg_t.d_model)
    pos = np.arange(s, dtype=np.int32) + (offset or 0)
    pl = jax.tree.map(lambda a: a[0], pj["layers"]["attn"])
    ref, _ = jattn.attention_forward(pl, cfg_j, jnp.asarray(x),
                                     jnp.asarray(pos), spec,
                                     logit_cap=cfg_j.attn_logit_softcap)
    got, _ = tattn.attention_forward(
        pt.layers[0].attn, cfg_t, torch.from_numpy(x),
        None if offset is None else torch.from_numpy(pos), _tspec(spec),
        logit_cap=cfg_t.attn_logit_softcap)
    close(got, ref, LOGIT_ATOL)


@pytest.mark.parametrize("clen", [32, 16])
def test_attention_forward_prefill_then_decode_matches_jax(clen):
    """clen 32 > S writes the prompt at row 0; clen 16 < S takes the rolled
    ring-buffer branch; then decode steps over the cache, wrapping."""
    name = "gemma2-2b"
    cfg_j, cfg_t, pj, pt = lm_pair(name)
    spec = jattn.MaskSpec(causal=True, window=12)
    rng = np.random.default_rng(5)
    b, s = 2, 24
    shape = (b, clen, cfg_t.num_kv_heads, cfg_t.hd)
    kc_j, vc_j = jnp.zeros(shape), jnp.zeros(shape)
    kc_t, vc_t = torch.zeros(shape), torch.zeros(shape)
    pl = jax.tree.map(lambda a: a[0], pj["layers"]["attn"])
    pa = pt.layers[0].attn
    cap = cfg_t.attn_logit_softcap

    x = normal(rng, b, s, cfg_t.d_model)
    ref, (kc_j, vc_j) = jattn.attention_forward(
        pl, cfg_j, jnp.asarray(x), jnp.arange(s), spec,
        cache=(kc_j, vc_j), cache_index=jnp.zeros((), jnp.int32),
        logit_cap=cap)
    got, _ = tattn.attention_forward(
        pa, cfg_t, torch.from_numpy(x), None, _tspec(spec),
        cache=(kc_t, vc_t), cache_index=0, logit_cap=cap)
    close(got, ref, LOGIT_ATOL)
    close(kc_t, kc_j, PRIM_ATOL)
    close(vc_t, vc_j, PRIM_ATOL)

    for index in range(s, s + 3):
        x = normal(rng, b, 1, cfg_t.d_model)
        ref, (kc_j, vc_j) = jattn.attention_forward(
            pl, cfg_j, jnp.asarray(x), jnp.asarray([index]), spec,
            cache=(kc_j, vc_j), cache_index=jnp.asarray(index % clen),
            cache_positions=jattn.ring_positions(jnp.asarray(index), clen),
            logit_cap=cap)
        got, _ = tattn.attention_forward(
            pa, cfg_t, torch.from_numpy(x), torch.tensor([index]),
            _tspec(spec), cache=(kc_t, vc_t), cache_index=index % clen,
            cache_positions=tattn.ring_positions(index, clen, "cpu"),
            logit_cap=cap)
        close(got, ref, LOGIT_ATOL)
        close(kc_t, kc_j, PRIM_ATOL)


def test_attend_none_positions_equal_arange():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(normal(rng, 1, 20, h, 16)) for h in (4, 2, 2))
    spec = tattn.MaskSpec(causal=True, window=6)
    a = tattn.attend(q, k, v, None, None, spec, 20.0)
    b = tattn.attend(q, k, v, torch.arange(20), torch.arange(20), spec, 20.0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------- #
# whole model
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["qwen3-8b", "gemma2-2b", "qwen2-moe-a2.7b",
                                  "mixtral-8x7b"])
def test_lm_prefill_and_decode_logits_match_jax(name):
    cfg_j, cfg_t, pj, pt = lm_pair(name)
    rng = np.random.default_rng(7)
    b, s, max_len = 2, 20, 32
    tokens = rng.integers(1, cfg_t.vocab_size, (b, s), dtype=np.int32)
    caches_j = jtf.init_kv_caches(cfg_j, b, max_len)
    caches_t = ttf.init_kv_caches(cfg_t, b, max_len, device="cpu")
    caches_j, ref = jtf.lm_prefill(pj, cfg_j, jnp.asarray(tokens), caches_j)
    caches_t, got = ttf.lm_prefill(pt, cfg_t, torch.from_numpy(tokens),
                                   caches_t)
    assert got.dtype == torch.float32 and got.shape == (b, 1,
                                                        cfg_t.vocab_size)
    close(got, ref, LOGIT_ATOL)
    for index in range(s, s + 4):
        tok = np.array(jnp.argmax(ref[:, -1], axis=-1))[:, None]
        ref, caches_j = jtf.lm_decode_step(
            pj, cfg_j, jnp.asarray(tok, jnp.int32), caches_j,
            jnp.asarray(index, jnp.int32))
        got, caches_t = ttf.lm_decode_step(
            pt, cfg_t, torch.from_numpy(tok).long(), caches_t, index)
        close(got, ref, LOGIT_ATOL)
    close(caches_t[0], caches_j[0], LOGIT_ATOL)
