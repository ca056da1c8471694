"""The port's serving path against the JAX reference on the CPU: the engine
with the same weights, the launch entry point, and the port's isolation from
jax and repro."""
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro.models import transformer as jtf
from repro.serve import Request as JaxRequest
from repro.serve import ServingEngine as JaxEngine
from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models import transformer as ttf
from repro_torch.serve import Request, ServingEngine

torch.set_num_threads(1)

LOGIT_ATOL = 1e-4   # fp32; the frameworks sum in different orders
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def requests(cls):
    """The requests of tests/test_serve.py."""
    return [cls(uid=i, prompt=np.arange(4 + i, dtype=np.int32) + 1,
                max_new_tokens=6) for i in range(5)]


@pytest.mark.parametrize("name", ["qwen3-8b", "gemma2-2b"])
def test_engine_tokens_and_logits_match_jax(name):
    cfg_j, cfg_t = jax_reduced(name), reduced_config(name)
    model_j = jax_build(cfg_j)
    pj = model_j.init(jax.random.PRNGKey(0))
    pt = from_jax_params(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")

    eng_j = JaxEngine(model_j, pj, batch_size=2, max_len=128)
    eng_t = ServingEngine(build_model(cfg_t), pt, batch_size=2, max_len=128)
    for r in requests(JaxRequest):
        eng_j.submit(r)
    for r in requests(Request):
        eng_t.submit(r)
    outs_j, outs_t = eng_j.run(), eng_t.run()
    assert [o.uid for o in outs_t] == [o.uid for o in outs_j]
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.prompt_len == b.prompt_len

    # per-step logits, teacher-forced on the reference's tokens
    prefill_j = jax.jit(jtf.lm_prefill, static_argnums=1)
    decode_j = jax.jit(jtf.lm_decode_step, static_argnums=1)
    for start in range(0, 5, 2):
        batch = outs_j[start:start + 2]
        plen = max(o.prompt_len for o in batch)
        toks = np.zeros((len(batch), plen), np.int32)
        for i, o in enumerate(batch):
            toks[i, plen - o.prompt_len:] = o.tokens[:o.prompt_len]
        clen = min(128, plen + 6 + 1)
        cj = jtf.init_kv_caches(cfg_j, len(batch), clen)
        ct = ttf.init_kv_caches(cfg_t, len(batch), clen, device="cpu")
        cj, lj = prefill_j(pj, cfg_j, jnp.asarray(toks), cj)
        with torch.inference_mode():
            ct, lt = ttf.lm_prefill(pt, cfg_t, torch.from_numpy(toks), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL)
        for step in range(5):
            tok = np.array([[o.tokens[o.prompt_len + step]] for o in batch],
                           np.int32)
            lj, cj = decode_j(pj, cfg_j, jnp.asarray(tok), cj,
                              jnp.asarray(plen + step, jnp.int32))
            with torch.inference_mode():
                lt, ct = ttf.lm_decode_step(pt, cfg_t,
                                            torch.from_numpy(tok).long(), ct,
                                            plen + step)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                       atol=LOGIT_ATOL)


def ssm_requests(cls, lengths):
    """Requests of the given prompt lengths, prompts 1, 2, 3, ..."""
    return [cls(uid=i, prompt=(np.arange(n, dtype=np.int32) % 200) + 1,
                max_new_tokens=5) for i, n in enumerate(lengths)]


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-1.2b"])
def test_engine_tokens_match_jax_for_ssm_families(name):
    """Two batches of 2: prompts of 32 and 20 tokens, padded to 32, a
    multiple of the reduced chunk (16), so prefill takes the SSD block; then
    7 and 11, padded to 11, which takes the sequential recurrence.  Greedy
    tokens equal the JAX engine's."""
    cfg_j, cfg_t = jax_reduced(name), reduced_config(name)
    model_j = jax_build(cfg_j)
    pj = model_j.init(jax.random.PRNGKey(1))
    pt = from_jax_params(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    lengths = [32, 20, 7, 11]
    eng_j = JaxEngine(model_j, pj, batch_size=2, max_len=64)
    eng_t = ServingEngine(build_model(cfg_t), pt, batch_size=2, max_len=64)
    for r in ssm_requests(JaxRequest, lengths):
        eng_j.submit(r)
    for r in ssm_requests(Request, lengths):
        eng_t.submit(r)
    outs_j, outs_t = eng_j.run(), eng_t.run()
    assert [o.uid for o in outs_t] == [o.uid for o in outs_j]
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.prompt_len == b.prompt_len
    assert eng_t.stats["prefill_tokens"] == 2 * 32 + 2 * 11


def test_engine_records_phase_stats():
    cfg = reduced_config("qwen3-8b")
    model = build_model(cfg)
    eng = ServingEngine(model, model.init(0, device="cpu"), batch_size=2,
                        max_len=64)
    for r in requests(Request):
        eng.submit(r)
    outs = eng.run()
    assert all(len(o.tokens) == o.prompt_len + 6 for o in outs)
    # three batches padded to 5, 7 and 8 positions; 5 decode steps each
    assert eng.stats["prefill_tokens"] == 2 * 5 + 2 * 7 + 1 * 8
    assert eng.stats["decode_tokens"] == 5 * (2 + 2 + 1)
    assert eng.stats["prefill_s"] > 0 and eng.stats["decode_s"] > 0


def test_launch_serve_runs_on_cpu_when_asked(capsys):
    rc = launch_serve.main(["--arch", "gemma2-2b", "--reduced", "--device",
                            "cpu", "--requests", "3", "--new-tokens", "4"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("req ")]
    assert len(lines) == 3
    assert all("-> 4 new tokens" in l for l in lines)


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-1.2b"])
@pytest.mark.parametrize("prompt_len", [0, 32])
def test_launch_serve_ssm_families_run_on_cpu_when_asked(capsys, name,
                                                         prompt_len):
    """Random prompt lengths, and --prompt-len 32: a multiple of the reduced
    chunk, so every prefill takes the SSD block."""
    rc = launch_serve.main(["--arch", name, "--reduced", "--device", "cpu",
                            "--requests", "3", "--new-tokens", "4",
                            "--prompt-len", str(prompt_len)])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("req ")]
    assert len(lines) == 3
    assert all("-> 4 new tokens" in l for l in lines)
    if prompt_len:
        assert all(l.startswith(f"req {i}: 32 prompt")
                   for i, l in enumerate(lines))


def test_launch_serve_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_serve.main(["--arch", "qwen3-8b", "--reduced"])


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(out.stdout.split())
    assert len(names) >= 25                 # every module was imported
    assert {"repro_torch.cache", "repro_torch.cache.store",
            "repro_torch.train.checkpoint",
            "repro_torch.train.fault_tolerance"} <= names


FORBIDDEN = re.compile(r"\bimport jax\b|\bfrom jax\b|\bimport repro\b(?!_)"
                       r"|\bfrom repro\.")


def test_port_sources_name_neither_jax_nor_repro():
    """The text of every module of the port and of chip_smoke.py, so imports
    inside functions count too: no `import jax`, `from jax`, `import repro`
    or `from repro.` (repro_torch is the port itself)."""
    root = pathlib.Path(SRC).parent
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 40
    hits = [f"{f.relative_to(root)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if FORBIDDEN.search(line)]
    assert not hits, hits
    assert FORBIDDEN.search("    from repro.core.graph import DiGraph")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from repro_torch.core import plan")

