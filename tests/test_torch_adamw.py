"""The optimizer's two paths: the multi-tensor AdamW kernel's host side
(`repro_torch.kernels.adamw`: the chunk table, the tensor rows, the
Plan's limit) and which path `adamw_update` takes for which input.  The loop's
numbers against the reference are `tests/test_torch_train.py`'s
`test_adamw_update_matches_jax`; the kernel's against the loop need the card
(`card` tests here, and chip_smoke.py's `adamw` phase)."""
import numpy as np
import pytest
import torch
from torch import nn

from repro_torch.kernels import adamw as K
from repro_torch.train import AdamWConfig, adamw_update, init_adamw
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)

ODD = [(1,), (3,), (7,), (4097,), (2 ** 20 + 5,), (3, 7), (1, 1), (4097, 3),
       (7, 1, 3), (5, 2 ** 12)]


@pytest.mark.parametrize("chunk", [K.CHUNK, 4096, 7])
def test_chunk_table_covers_every_element_once(chunk, monkeypatch):
    monkeypatch.setattr(K, "CHUNK", chunk)
    numels = [int(np.prod(s)) for s in ODD]
    table = K.chunk_table(numels)
    seen = [np.zeros(n, np.int64) for n in numels]
    for t, start, length in table:
        assert 0 < length <= chunk
        assert 0 <= start and start + length <= numels[t]   # one tensor
        seen[t][start:start + length] += 1
    assert all((s == 1).all() for s in seen)
    assert len(table) == sum(-(-n // chunk) for n in numels)


def test_tensor_rows_set_decay_exactly_on_2d_and_more():
    ps = [torch.zeros(s) for s in ODD]
    rows = [K.tensor_row(p, torch.zeros_like(p), torch.zeros_like(p))
            for p in ps]
    assert [r[4] for r in rows] == [int(p.dim() >= 2) for p in ps]
    assert [r[3] for r in rows] == [p.numel() for p in ps]
    assert [r[0] for r in rows] == [p.data_ptr() for p in ps]


def test_plan_refuses_more_tensors_than_a_launch_takes():
    """The gradients' pointers travel in the launch's parameters: at most
    MAX_TENSORS of them (every configuration has far fewer: whisper-medium
    507, mamba2-780m 434)."""
    rows = [(0, 0, 0, 1, 0)] * (K.MAX_TENSORS + 1)
    with pytest.raises(ValueError, match="more than the 1024"):
        K.Plan(rows, torch.device("cpu"))
    plan = K.Plan(rows[:K.MAX_TENSORS], torch.device("cpu"))
    assert plan.numel == K.MAX_TENSORS == plan.partials.numel()


def test_constants_round_as_float32_tensors_see_python_scalars():
    b1c, b2c = 1 - 0.9 ** 2, 1 - 0.95 ** 2
    b1c, b2c = float(np.float32(b1c)), float(np.float32(b2c))
    k = K.constants(0.9, 0.95, 1e-8, 0.1, 1e-3, b1c, b2c)
    f = np.float32
    assert k == tuple(float(x) for x in (
        f(0.9), f(0.09999999999999998), f(0.95), f(0.050000000000000044),
        f(1) / f(b1c), f(1) / f(b2c), f(1e-8), f(0.1), f(1e-3)))
    assert all(float(np.float32(x)) == x for x in k)


def _params(shapes, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return nn.ParameterDict({f"w{i}": nn.Parameter(
        torch.randn(s, generator=gen).to(device))
        for i, s in enumerate(shapes)})


def _grads(params, seed):
    gen = torch.Generator().manual_seed(seed)
    return {n: torch.randn(p.shape, generator=gen).to(p.device)
            for n, p in params.named_parameters()}


def test_cpu_tensors_take_the_loop():
    params = _params(ODD[:6], 0)
    state = init_adamw(params)
    kernel, loop = opt.UPDATED.kernel, opt.UPDATED.loop
    launches = K.NORM_KERNEL.launches, K.UPDATE_KERNEL.launches
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    _, state, metrics = adamw_update(AdamWConfig(lr=1e-2, warmup_steps=1),
                                     _grads(params, 1), state, params)
    assert opt.UPDATED.loop - loop == sum(p.numel()
                                          for p in params.parameters())
    assert opt.UPDATED.kernel == kernel
    assert (K.NORM_KERNEL.launches, K.UPDATE_KERNEL.launches) == launches
    assert state.step == 1 and metrics["grad_norm"].shape == ()
    assert all(not torch.equal(p, before[n])
               for n, p in params.named_parameters())


def test_dtensors_take_the_loop():
    """DTensor parameters (a 1 x 1 mesh on the CPU) take the loop and give
    the plain tensors' update."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    shapes, cfg = ODD[:6], AdamWConfig(lr=1e-2, warmup_steps=1)
    plain = _params(shapes, 0)
    plain_state = init_adamw(plain)
    adamw_update(cfg, _grads(plain, 1), plain_state, plain)
    dryrun.fake_group(1)
    try:
        mesh = make_mesh(1, 1, "cpu")
        rep = [Replicate(), Replicate()]

        def place(t):
            return DTensor.from_local(t, mesh, rep, run_check=False)
        placed = _params(shapes, 0)
        for n, p in list(placed.named_parameters()):
            placed[n] = nn.Parameter(place(p.detach()))
        state = init_adamw(placed)
        state = opt.AdamWState(0, {n: place(v.to_local() if isinstance(
            v, DTensor) else v) for n, v in state.mu.items()},
            {n: place(v.to_local() if isinstance(v, DTensor) else v)
             for n, v in state.nu.items()})
        grads = {n: place(g) for n, g in _grads(placed, 1).items()}
        kernel, loop = opt.UPDATED.kernel, opt.UPDATED.loop
        adamw_update(cfg, grads, state, placed)
        assert opt.UPDATED.kernel == kernel
        assert opt.UPDATED.loop - loop == sum(p.numel()
                                              for p in plain.parameters())
        for n, p in placed.named_parameters():
            assert torch.equal(p.to_local(), plain[n].detach())
            assert torch.equal(state.mu[n].to_local(), plain_state.mu[n])
    finally:
        dist.destroy_process_group()


class _CudaStandIn:
    """Stands for a plain CUDA parameter in `_on_kernel`'s decision."""
    is_cuda = True


def test_the_kernel_path_needs_plain_cuda_params_and_no_dispatch_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    named = [("a", _CudaStandIn()), ("b", _CudaStandIn())]
    assert opt._on_kernel(named)
    assert not opt._on_kernel([])
    assert not opt._on_kernel([("a", torch.zeros(2))])
    with FakeTensorMode():
        assert not opt._on_kernel(named)


@pytest.mark.card
def test_cuda_float32_takes_the_kernel_bit_equal_to_the_loop():
    """The kernel path on the card: two launches a step, every element
    counted, and p, mu, nu torch.equal to the loop run from the kernel's
    scale, over three steps and the odd sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1)
    ker, loop = _params(ODD, 0, "cuda"), _params(ODD, 0, "cuda")
    ks, ls = init_adamw(ker), init_adamw(loop)
    named = list(loop.named_parameters())
    for step in range(3):
        grads = _grads(ker, 1 + step)
        lr = opt.lr_schedule(cfg, ks.step)
        b1c, b2c = opt._bias_corrections(cfg, ks.step + 1)
        counted = opt.UPDATED.kernel
        launches = K.NORM_KERNEL.launches + K.UPDATE_KERNEL.launches
        _, ks, metrics = adamw_update(cfg, grads, ks, ker)
        assert K.NORM_KERNEL.launches + K.UPDATE_KERNEL.launches \
            - launches == 2
        assert opt.UPDATED.kernel - counted == sum(p.numel()
                                                   for p in ker.parameters())
        gnorm = metrics["grad_norm"]
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        opt._loop(cfg, _grads(ker, 1 + step), ls, named, scale, lr, b1c,
                  b2c)
        for n, p in named:
            assert torch.equal(ker[n], p), (step, n)
            assert torch.equal(ks.mu[n], ls.mu[n]), (step, n)
            assert torch.equal(ks.nu[n], ls.nu[n]), (step, n)
    bad = {n: g.double() for n, g in _grads(ker, 9).items()}
    with pytest.raises(ValueError, match="the grad of 'w0'"):
        adamw_update(cfg, bad, ks, ker)
    # the same address and size as a cached Plan's row, another dtype or
    # layout: refused, not written through as float32
    mu3, mu5 = ks.mu["w3"], ks.mu["w5"]
    ks.mu["w3"] = mu3.view(torch.bfloat16)[:mu3.numel()]
    with pytest.raises(ValueError, match="the mu of 'w3'"):
        adamw_update(cfg, _grads(ker, 10), ks, ker)
    ks.mu["w3"], ks.mu["w5"] = mu3, mu5.t()
    with pytest.raises(ValueError, match="the mu of 'w5'"):
        adamw_update(cfg, _grads(ker, 11), ks, ker)
