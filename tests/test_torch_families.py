"""The port's vlm (paligemma) and audio (whisper) families against the JAX
reference on the CPU, with the same numpy inputs and the same weights
(carried across by from_jax_params): cross-attention, prefill and decode,
the serving engine with frontend extras, and the serve launcher.

Tolerances (float32; the frameworks sum in different orders): 1e-5 on one
attention block, 1e-4 on encoder outputs and logits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import encdec as jed
from repro.models import transformer as jtf
from repro.models import vlm as jvlm
from repro.serve import Request as JaxRequest
from repro.serve import ServingEngine as JaxEngine
from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import encdec as ted
from repro_torch.models import transformer as ttf
from repro_torch.models import vlm as tvlm
from repro_torch.models.encdec import EncDecLM
from repro_torch.serve import Request, ServingEngine

torch.set_num_threads(1)

ATTN_ATOL = 1e-5
LOGIT_ATOL = 1e-4


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def pair(name, seed=0, **overrides):
    """(jax cfg, port cfg, jax params, port module) with equal weights; the
    norms (zero at init) get random values so (1 + w) is exercised."""
    cfg_j = jax_reduced(name, **overrides)
    cfg_t = reduced_config(name, **overrides)
    tree = jax.tree.map(np.asarray, jax_build(cfg_j).init(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        last = path[-1].key
        if last.startswith("ln_") or last in ("q_norm", "k_norm",
                                              "final_norm", "enc_norm"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return (cfg_j, cfg_t, jax.tree.map(jnp.asarray, tree),
            from_jax_params(cfg_t, tree, device="cpu"))


# ---------------------------------------------------------------------- #
# cross-attention
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("s,index", [(7, None), (1, 9)])
def test_attention_forward_kv_override_matches_jax(qk_norm, s, index):
    """Sq != T: a prompt of 7 rows (the port passes positions None) and a
    decode row at position 9, over 20 precomputed k/v rows."""
    cfg_j, cfg_t, pj, pt = pair("whisper-medium", qk_norm=qk_norm)
    rng = np.random.default_rng(1)
    t = 20
    x = normal(rng, 2, s, cfg_t.d_model)
    k, v = (normal(rng, 2, t, cfg_t.num_kv_heads, cfg_t.hd) for _ in "kv")
    pos = np.arange(s) if index is None else np.array([index])
    pl = jax.tree.map(lambda a: a[0], pj["dec_layers"]["cross_attn"])
    ref, _ = jattn.attention_forward(
        pl, cfg_j, jnp.asarray(x), jnp.asarray(pos), jattn.FULL,
        kv_override=(jnp.asarray(k), jnp.asarray(v)))
    got, cache = tattn.attention_forward(
        pt.dec_layers[0].cross_attn, cfg_t, torch.from_numpy(x),
        None if index is None else torch.from_numpy(pos), tattn.FULL,
        kv_override=(torch.from_numpy(k), torch.from_numpy(v)))
    assert cache is None
    close(got, ref, ATTN_ATOL)


# ---------------------------------------------------------------------- #
# vlm (paligemma)
# ---------------------------------------------------------------------- #

def test_vlm_prefill_and_decode_match_jax():
    cfg_j, cfg_t, pj, pt = pair("paligemma-3b")
    rng = np.random.default_rng(2)
    b, s, max_len = 2, 12, 48
    p = cfg_t.num_image_tokens
    patches = normal(rng, b, p, cfg_t.d_model, scale=0.02)
    tokens = rng.integers(1, cfg_t.vocab_size, (b, s), dtype=np.int32)
    cj = jtf.init_kv_caches(cfg_j, b, max_len)
    ct = ttf.init_kv_caches(cfg_t, b, max_len, device="cpu")
    cj, ref = jvlm.vlm_prefill(pj, cfg_j, jnp.asarray(patches),
                               jnp.asarray(tokens), cj)
    ct, got = tvlm.vlm_prefill(pt, cfg_t, torch.from_numpy(patches),
                               torch.from_numpy(tokens).long(), ct)
    assert got.shape == (b, 1, cfg_t.vocab_size)
    close(got, ref, LOGIT_ATOL)
    for index in range(p + s, p + s + 4):
        tok = np.array(jnp.argmax(ref[:, -1], axis=-1))[:, None]
        ref, cj = jvlm.vlm_decode_step(pj, cfg_j, jnp.asarray(tok, jnp.int32),
                                       cj, jnp.asarray(index, jnp.int32))
        got, ct = tvlm.vlm_decode_step(pt, cfg_t, torch.from_numpy(tok).long(),
                                       ct, index)
        close(got, ref, LOGIT_ATOL)
    close(ct[0], cj[0], LOGIT_ATOL)


# ---------------------------------------------------------------------- #
# audio (whisper)
# ---------------------------------------------------------------------- #

def test_sinusoid_positions_equal_the_reference():
    np.testing.assert_array_equal(ted.sinusoid_positions(70, 64),
                                  jed.sinusoid_positions(70, 64))


def test_whisper_encode_prefill_and_decode_match_jax():
    cfg_j, cfg_t, pj, pt = pair("whisper-medium")
    rng = np.random.default_rng(3)
    b, s, max_len = 2, 10, 32
    audio = normal(rng, b, cfg_t.encoder_seq, cfg_t.d_model, scale=0.02)
    tokens = rng.integers(1, cfg_t.vocab_size, (b, s), dtype=np.int32)
    close(ted.encode(pt, cfg_t, torch.from_numpy(audio)),
          jed.encode(pj, cfg_j, jnp.asarray(audio)), LOGIT_ATOL)
    cj = jtf.init_kv_caches(cfg_j, b, max_len)
    ct = ttf.init_kv_caches(cfg_t, b, max_len, device="cpu")
    cj, enc_j, ref = jed.encdec_prefill(pj, cfg_j, jnp.asarray(audio),
                                        jnp.asarray(tokens), cj)
    ct, enc_t, got = ted.encdec_prefill(pt, cfg_t, torch.from_numpy(audio),
                                        torch.from_numpy(tokens).long(), ct)
    close(enc_t, enc_j, LOGIT_ATOL)
    close(got, ref, LOGIT_ATOL)
    for index in range(s, s + 4):
        tok = np.array(jnp.argmax(ref[:, -1], axis=-1))[:, None]
        ref, cj = jed.encdec_decode_step(
            pj, cfg_j, jnp.asarray(tok, jnp.int32), enc_j, cj,
            jnp.asarray(index, jnp.int32))
        got, ct = ted.encdec_decode_step(
            pt, cfg_t, torch.from_numpy(tok).long(), enc_t, ct, index)
        close(got, ref, LOGIT_ATOL)
    close(ct[1], cj[1], LOGIT_ATOL)


def _extras(cfg, b, seed):
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patch_embed": normal(rng, b, cfg.num_image_tokens,
                                      cfg.d_model, scale=0.02)}
    return {"audio_embed": normal(rng, b, cfg.encoder_seq, cfg.d_model,
                                  scale=0.02)}


@pytest.mark.parametrize("name", ["paligemma-3b", "whisper-medium"])
def test_decode_consistent_with_prefill(name):
    """decode_step(t_S) logits equal those of a prefill over [0..S], as the
    reference's tests/test_models.py holds its own Model."""
    cfg = reduced_config(name)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 17
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1)))
    batch = {k: torch.from_numpy(v) for k, v in _extras(cfg, b, 5).items()}
    prefix = cfg.num_image_tokens if cfg.family == "vlm" else 0
    with torch.inference_mode():
        state = model.init_decode_state(b, 64 + prefix, device="cpu")
        state, _ = model.prefill(params, dict(batch, tokens=tokens[:, :s]),
                                 state)
        dec, _ = model.decode_step(params, tokens[:, s:], state, s + prefix)
        full = model.init_decode_state(b, 64 + prefix, device="cpu")
        _, ref = model.prefill(params, dict(batch, tokens=tokens), full)
    close(dec, ref.numpy(), LOGIT_ATOL)


# ---------------------------------------------------------------------- #
# conversion
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["paligemma-3b", "whisper-medium"])
def test_from_jax_params_round_trips_the_tree(name):
    """Every leaf of the reference's tree lands in one port parameter
    (transposed for an nn.Linear), every port parameter comes from one
    leaf, and the port's own init has the same shapes."""
    cfg_j, cfg_t = jax_reduced(name), reduced_config(name)
    tree = jax.tree.map(np.asarray, jax_build(cfg_j).init(
        jax.random.PRNGKey(6)))
    pt = from_jax_params(cfg_t, tree, device="cpu")
    sd = pt.state_dict()
    stacked = {"layers": cfg_t.num_layers, "enc_layers": cfg_t.encoder_layers,
               "dec_layers": cfg_t.num_layers}
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key for k in path]
        slices = range(stacked[keys[0]]) if keys[0] in stacked else [None]
        for i in slices:
            name_ = ".".join(keys[:1] + ([str(i)] if i is not None else [])
                             + keys[1:])
            value = leaf if i is None else leaf[i]
            if name_ + ".weight" in sd:
                name_, value = name_ + ".weight", value.T
            np.testing.assert_array_equal(sd[name_].numpy(), value)
            seen.add(name_)
    assert seen == set(sd)
    own = build_model(cfg_t).init(0, device="cpu")
    assert isinstance(own, EncDecLM) == (cfg_t.family == "audio")
    assert {k: v.shape for k, v in own.state_dict().items()} == \
        {k: v.shape for k, v in sd.items()}


# ---------------------------------------------------------------------- #
# the engine and the launcher
# ---------------------------------------------------------------------- #

def family_requests(cls, cfg, lengths):
    """Requests with prompts 1, 2, 3, ... and the stub frontend's output in
    `extras`, one draw per request."""
    out = []
    for i, n in enumerate(lengths):
        extras = {k: v[0] for k, v in _extras(cfg, 1, 10 + i).items()}
        out.append(cls(uid=i, prompt=(np.arange(n, dtype=np.int32) % 200) + 1,
                       max_new_tokens=5, extras=extras))
    return out


@pytest.mark.parametrize("name", ["paligemma-3b", "whisper-medium"])
def test_engine_tokens_match_jax_with_extras(name):
    """Two batches of 2 (prompts 9 and 4, then 6 and 6; the shorter
    left-padded with token 0): greedy tokens equal the JAX engine's, and
    the vlm batches' caches and positions count the patches."""
    cfg_j, cfg_t = jax_reduced(name), reduced_config(name)
    model_j = jax_build(cfg_j)
    pj = model_j.init(jax.random.PRNGKey(7))
    pt = from_jax_params(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    lengths = [9, 4, 6, 6]
    eng_j = JaxEngine(model_j, pj, batch_size=2, max_len=64)
    eng_t = ServingEngine(build_model(cfg_t), pt, batch_size=2, max_len=64)
    for r in family_requests(JaxRequest, cfg_t, lengths):
        eng_j.submit(r)
    for r in family_requests(Request, cfg_t, lengths):
        eng_t.submit(r)
    outs_j, outs_t = eng_j.run(), eng_t.run()
    assert [o.uid for o in outs_t] == [o.uid for o in outs_j]
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.prompt_len == b.prompt_len == lengths[a.uid]
        assert len(a.tokens) == a.prompt_len + 5
    prefix = cfg_t.num_image_tokens if cfg_t.family == "vlm" else 0
    assert eng_t.stats["prefill_tokens"] == 2 * (9 + prefix) + 2 * (6 + prefix)


@pytest.mark.parametrize("name", ["paligemma-3b", "whisper-medium"])
def test_launch_serve_families_run_on_cpu_when_asked(capsys, name):
    rc = launch_serve.main(["--arch", name, "--reduced", "--device", "cpu",
                            "--requests", "3", "--new-tokens", "4"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("req ")]
    assert len(lines) == 3
    assert all("-> 4 new tokens" in l for l in lines)


@pytest.mark.parametrize("name", ["paligemma-3b", "whisper-medium",
                                  "qwen3-8b"])
def test_launch_serve_frontend_stub_is_seeded_per_request(name):
    cfg = reduced_config(name)
    a = launch_serve.frontend_stub(cfg, 3, 1)
    if cfg.family not in ("vlm", "audio"):
        assert a is None
        return
    (field, value), = a.items()
    rows = cfg.num_image_tokens if cfg.family == "vlm" else cfg.encoder_seq
    assert value.shape == (rows, cfg.d_model) and value.dtype == np.float32
    np.testing.assert_array_equal(
        value, launch_serve.frontend_stub(cfg, 3, 1)[field])
    assert not np.array_equal(value,
                              launch_serve.frontend_stub(cfg, 3, 2)[field])
    assert 0.015 < float(value.std()) < 0.025
