"""The port's span recorder (repro_torch.obs): off by default and then one
shared no-op; nesting and parent indices, across threads; and the spans of
the train step, whose numbers it leaves bitwise unchanged."""
from __future__ import annotations

import contextlib
import sys
import threading
from collections import Counter

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.train import (AdamWConfig, TrainConfig, init_train_state,
                               loss_and_grad, make_train_step)

LAYERS = 4


@pytest.fixture(autouse=True)
def recorder_left_off():
    assert obs._recorder is None
    yield
    assert obs._recorder is None


def test_off_records_nothing_and_returns_one_shared_context():
    a, b = obs.span("a"), obs.span("b")
    assert a is b
    with a:
        with b:
            pass
    x = torch.ones(3, requires_grad=True)
    out = obs.backward_span("f", lambda t: (t,), x)
    assert out[0] is x


def test_nesting_and_parents_across_a_thread():
    def work():
        with obs.span("thread"):
            with obs.span("inner"):
                pass

    with obs.recording() as spans:
        with obs.span("top"):
            with obs.span("child"):
                pass
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with obs.span("next"):
            pass
    assert [s.name for s in spans] == ["top", "child", "thread", "inner",
                                       "next"]
    assert [s.parent for s in spans] == [None, 0, 0, 2, None]
    assert spans[2].thread == spans[3].thread != spans[0].thread
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_recording_is_not_nested_and_ends_on_an_error():
    with pytest.raises(ValueError):
        with obs.recording():
            with pytest.raises(RuntimeError):
                with obs.recording():
                    pass
            raise ValueError("inside")


def test_threads_recording_at_once_lose_no_span():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with obs.span("w"):
                    pass
        with obs.recording() as spans:
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert obs._recorder._open == []
    finally:
        sys.setswitchinterval(old)
    assert len(spans) == 16 * 200
    assert all(s.end_ns is not None for s in spans)
    assert all(s.parent is None or 0 <= s.parent < len(spans)
               for s in spans)


def test_backward_span_covers_the_backward_pass():
    x = torch.arange(4.0, requires_grad=True)
    keep = torch.ones(2)                    # needs no gradient
    with obs.recording() as spans:
        with obs.span("fwd"):
            y, k = obs.backward_span("f", lambda t, u: (t * 3, u * 2),
                                     x, keep)
        assert not k.requires_grad
        with obs.span("bwd"):
            y.sum().backward()
    assert [(s.name, s.parent) for s in spans] == [
        ("fwd", None), ("bwd", None), ("f", 1)]
    assert torch.equal(x.grad, torch.full((4,), 3.0))


def _tiny():
    cfg = reduced_config("mamba2-780m", num_layers=LAYERS)
    model = build_model(cfg, remat=True)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=2,
                                           total_steps=10),
                     compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(5)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                        generator=gen)} for _ in range(2)]
    return model, tc, batches


def test_train_step_spans_of_a_tiny_mamba2():
    model, tc, batches = _tiny()
    params, opt = init_train_state(model, 3, "cpu")
    step = make_train_step(model, tc)
    with obs.recording() as spans:
        for batch in batches:
            params, opt, _ = step(params, opt, batch)
    names = [s.name for s in spans]
    top = [s.name for s in spans if s.parent is None]
    assert top == ["train.forward", "train.backward", "train.adamw"] * 2
    assert Counter(names) == {"train.forward": 2, "train.backward": 2,
                              "train.adamw": 2,
                              "train.recompute": 2 * LAYERS,
                              "ssm.ssd": 2 * 3 * LAYERS}

    def under(s):
        return spans[s.parent].name
    for s in spans:
        assert s.end_ns is not None
        if s.name == "train.recompute":
            assert under(s) == "train.backward"
    ssd = Counter(under(s) for s in spans if s.name == "ssm.ssd")
    assert ssd == {"train.forward": 2 * LAYERS,
                   "train.recompute": 2 * LAYERS,
                   "train.backward": 2 * LAYERS}
    # in the backward pass a layer is recomputed, then its SSD's gradient
    # runs outside the recomputation
    order = [s.name for s in spans
             if s.parent is not None and under(s) == "train.backward"]
    assert order[:2] == ["train.recompute", "ssm.ssd"]


def _train(record: bool):
    model, tc, batches = _tiny()
    params, opt = init_train_state(model, 3, "cpu")
    step = make_train_step(model, tc)
    out = {}
    with obs.recording() if record else contextlib.nullcontext():
        loss, grads, _ = loss_and_grad(model, params, batches[0], tc)
        out["grads"] = {n: g.clone() for n, g in grads.items()}
        out["first_loss"] = loss
        losses = []
        for batch in batches:
            params, opt, metrics = step(params, opt, batch)
            losses.append(metrics["loss"])
    out.update(losses=losses, params=dict(params.named_parameters()),
               mu=opt.mu, nu=opt.nu)
    return out


def test_recording_leaves_losses_gradients_and_moments_bitwise_equal():
    off, on = _train(False), _train(True)
    assert torch.equal(off["first_loss"], on["first_loss"])
    for a, b in zip(off["losses"], on["losses"]):
        assert torch.equal(a, b)
    for key in ("grads", "params", "mu", "nu"):
        assert off[key].keys() == on[key].keys()
        for n in off[key]:
            assert torch.equal(off[key][n], on[key][n]), (key, n)
