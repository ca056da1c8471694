"""The plain references: the bucket sum against a hand case, the Mamba2
family's layout against the port's parameters, its float32 loss and
gradients against the port's at a tiny size, and the configuration files
against the port's configurations."""
import dataclasses
import json
import math

import pytest
import torch

from bench import harness
from bench.reference import bucket_sum, mamba2_lm

from .tiny import TINY

SHAPES = {"a": (2, 3), "b": (4,)}


def test_bucket_sum_of_a_hand_case(monkeypatch):
    # rank r's gradients are all r + 1: the sum over 3 ranks is 6
    monkeypatch.setattr(bucket_sum, "_draw",
                        lambda out, seed, rank, bucket: out.fill_(rank + 1))
    total = bucket_sum.rank_sum(5, 0, ["a", "b"], SHAPES, 3, "cpu")
    assert total.dtype == torch.float64 and total.shape == (10,)
    assert torch.equal(total, torch.full((10,), 6.0, dtype=torch.float64))


def test_bucket_inputs_are_the_referenced_draws():
    stacked = bucket_sum.bucket_inputs(9, 2, ["a", "b"], SHAPES, [0, 1, 2],
                                       "cpu", True)
    assert stacked["a"].shape == (3, 2, 3) and stacked["b"].shape == (3, 4)
    flat = torch.cat([stacked[k].reshape(3, -1) for k in "ab"], -1)
    want = bucket_sum.rank_sum(9, 2, ["a", "b"], SHAPES, 3, "cpu")
    assert torch.allclose(flat.double().sum(0), want, rtol=0, atol=1e-12)
    one = bucket_sum.bucket_inputs(9, 2, ["a", "b"], SHAPES, [1], "cpu",
                                   False, flat=True)
    assert torch.equal(one, flat[1])
    other = bucket_sum.bucket_inputs(9, 3, ["a", "b"], SHAPES, [1], "cpu",
                                     False, flat=True)
    assert not torch.equal(one, other)


def _port_config(cfg):
    from repro_torch.models.common import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


@pytest.mark.parametrize("name", ["mamba2-780m"])
def test_configuration_files_are_the_ports_and_the_layout_its_parameters(
        name):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    entry = {c["name"]: c for c in harness.load_manifest()["configs"]}[name]
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    port = _port_config(cfg)
    assert port == get_config(name)
    with torch.device("meta"):
        module = build_model(port)._init_fn()(port, None, torch.float32,
                                               "meta")
    ours = [(n, s) for n, s, _ in mamba2_lm.layout(cfg)]
    assert ours == [(n, tuple(p.shape)) for n, p in module.named_parameters()]
    assert sum(math.prod(s) for _, s in ours) == cfg["params"]


def test_float32_loss_and_gradients_equal_the_ports():
    from repro_torch.models import build_model
    cfg = dict(TINY)
    model = build_model(_port_config(cfg), remat=True)
    weights = mamba2_lm.make_weights(cfg, 3, "cpu")
    params = model.init(0, torch.float32, "cpu")
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(weights[n])
    tokens = torch.randint(0, cfg["vocab_size"], (2, 48),
                           generator=torch.Generator().manual_seed(1))
    loss, _ = model.loss(params, {"tokens": tokens})
    loss.backward()
    w = {k: t.clone().requires_grad_() for k, t in weights.items()}
    ref = mamba2_lm.loss(w, cfg, tokens)
    ref.backward()
    loss, ref = float(loss.detach()), float(ref.detach())
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    for n, p in params.named_parameters():
        g, r = p.grad, w[n].grad
        assert torch.allclose(g, r, rtol=1e-3, atol=1e-4 * float(
            r.abs().max()) + 1e-9), n


def test_fp8_control_rounds_values_and_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = mamba2_lm._r(x, "fp8")
    assert not torch.equal(y, x) and (y - x).abs().max() <= 3 / 8
    y.backward(torch.linspace(0.001, 1, 101))
    assert len(torch.unique(x.grad)) < 101
    assert mamba2_lm._r(x, None) is x


def test_bf16_weights_round_the_forward_and_pass_the_gradient():
    w = {"a": torch.linspace(-1, 1, 33).add_(1e-3).requires_grad_()}
    held = mamba2_lm._held_as(w, "bfloat16")["a"]
    assert held.dtype == torch.float32
    assert torch.equal(held, w["a"].detach().bfloat16().float())
    assert not torch.equal(held, w["a"].detach())
    held.backward(torch.arange(33.0))
    assert torch.equal(w["a"].grad, torch.arange(33.0))
    assert mamba2_lm._held_as(w, None) is w


def test_adamw_matches_the_ports():
    from repro_torch.train import AdamWConfig, adamw_update, init_adamw
    opt = json.loads((harness.BENCH / "traffic" / "train_2x4096.json")
                     .read_text())["optimizer"]
    gen = torch.Generator().manual_seed(0)
    weights = {"w": torch.randn(4, 5, generator=gen),
               "v": torch.randn(7, generator=gen)}
    module = torch.nn.Module()
    for k, t in weights.items():
        module.register_parameter(k, torch.nn.Parameter(t.clone()))
    state = init_adamw(module)
    mu = {k: torch.zeros_like(t) for k, t in weights.items()}
    nu = {k: torch.zeros_like(t) for k, t in weights.items()}
    for step in range(3):
        grads = {k: torch.randn(t.shape, generator=gen) * 3
                 for k, t in weights.items()}
        module, state, _ = adamw_update(AdamWConfig(**opt),
                                        {k: g.clone() for k, g in
                                         grads.items()}, state, module)
        mamba2_lm.adamw(weights, grads, mu, nu, step, opt)
    for k, t in weights.items():
        assert torch.allclose(getattr(module, k), t, rtol=0, atol=1e-6)
