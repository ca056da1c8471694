"""The port's analysis (repro_torch.analysis) against the reference's
(src/repro/analysis): the shape grid, skips and cells, `model_flops_for`,
`RooflineTerms`, and the per-device counter `hlo_count.count` held to
`repro.analysis.hlo_count.count` of the same jitted function at one device
(the same weights through `from_jax_params`, the same numpy tokens,
reduced configs, B=2, S=64), and per device under DTensor on a fake
(16, 16) mesh.  The hand-written kernels' fake ops and FLOP formulas are
held to their plain versions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo_count as jhc
from repro.analysis import roofline as jroof
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.configs import reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro.topo.tpu import TPU_V5E
from repro_torch import configs as tconfigs
from repro_torch.analysis import hlo_count as thc
from repro_torch.analysis import profile_tools, report
from repro_torch.analysis.roofline import RooflineTerms, model_flops_for
from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ref as kref
from repro_torch.models import build_model
from repro_torch.topo.hardware import H100_SXM, HardwareSpec

torch.set_num_threads(1)

B, S = 2, 64
ARCH_NAMES = sorted(JAX_ARCHS)


# ---------------------------------------------------------------------- #
# shapes, skips, cells, model FLOPs, roofline terms
# ---------------------------------------------------------------------- #

def test_shapes_match_the_reference():
    assert [dataclasses.asdict(s) for s in tconfigs.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in jshapes.ALL_SHAPES]
    for s in jshapes.ALL_SHAPES:
        assert dataclasses.asdict(tconfigs.shape_by_name(s.name)) == \
            dataclasses.asdict(s)
    with pytest.raises(KeyError):
        tconfigs.shape_by_name("train_8k")


def test_cells_and_skips_match_the_reference():
    got = [(c.name, s.name, r) for c, s, r in tconfigs.cells()]
    ref = [(c.name, s.name, r) for c, s, r in jreg.cells()]
    assert len(got) == 40 and got == ref
    for arch in ARCH_NAMES:
        for s in jshapes.ALL_SHAPES:
            assert tconfigs.skip_reason(arch, tconfigs.shape_by_name(
                s.name)) == jreg.skip_reason(arch, s)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_match_the_reference(arch):
    for s in jshapes.ALL_SHAPES:
        assert model_flops_for(tconfigs.get_config(arch),
                               tconfigs.shape_by_name(s.name)) == \
            jroof.model_flops_for(JAX_ARCHS[arch], s)


def test_roofline_terms_match_the_reference():
    """The reference's test numbers, against a card whose peaks are the
    reference's TPU's: one second for each term on both sides."""
    hw = dataclasses.replace(
        H100_SXM, peak_flops_bf16=TPU_V5E.peak_flops_bf16,
        hbm_bw=TPU_V5E.hbm_bw, nic_bw=2 * TPU_V5E.ici_link_bw)
    kw = dict(arch="x", shape="train_4k", mesh="16x16", chips=256,
              hlo_flops=197e12, hlo_bytes=819e9,
              collective_bytes={"all-reduce": int(100e9)},
              model_flops=197e12 * 256)
    got, ref = RooflineTerms(hw=hw, **kw), jroof.RooflineTerms(**kw)
    for prop in ("compute_s", "memory_s", "collective_s", "dominant",
                 "useful_flops_ratio", "bound_s", "roofline_fraction"):
        assert getattr(got, prop) == pytest.approx(getattr(ref, prop))
    assert got.compute_s == pytest.approx(1.0)
    assert got.row().keys() == ref.row().keys()


def test_h100_spec_is_the_data_sheet():
    assert isinstance(H100_SXM, HardwareSpec)
    assert (H100_SXM.peak_flops_bf16, H100_SXM.peak_flops_f32,
            H100_SXM.hbm_bw) == (989e12, 67e12, 3.35e12)
    assert H100_SXM.nic_bw < H100_SXM.nvlink_bw
    # the collective term charges the NIC: a 16-wide axis leaves a node
    t = RooflineTerms("a", "s", "m", 1, 0.0, 0.0, {"all-gather": int(50e9)},
                      0.0)
    assert t.collective_s == pytest.approx(1.0) and t.dominant == \
        "collective"


# ---------------------------------------------------------------------- #
# per-device FLOPs at one device, against the reference's HLO count
# ---------------------------------------------------------------------- #

def _pair(arch):
    cfg = jax_reduced(arch)
    params = jax_build(cfg).init(jax.random.PRNGKey(0), jnp.float32)
    tcfg = reduced_config(arch)
    port = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    return cfg, params, tcfg, port, toks


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-2b",
                                  "qwen2-moe-a2.7b", "mamba2-780m"])
def test_prefill_flops_equal_the_reference(arch):
    """mamba2 once differed by C.B^T per head (the SSD block's plain
    version computed it H times; the reference once per batch row and
    chunk): repaired, so every family is equal."""
    cfg, params, tcfg, port, toks = _pair(arch)
    m = jax_build(cfg)
    state = m.init_decode_state(B, 2 * S, jnp.float32)
    text = jax.jit(m.prefill).lower(
        params, {"tokens": jnp.asarray(toks, jnp.int32)},
        state).compile().as_text()
    tm = build_model(tcfg)
    tstate = tm.init_decode_state(B, 2 * S, torch.float32, "cpu")
    with torch.no_grad():
        got = thc.count(tm.prefill, port, {"tokens": torch.tensor(toks)},
                        tstate)
    assert got["flops"] == jhc.count(text)["flops"] > 0


def _jax_train_flops(cfg, params, toks, remat, grad_only=False):
    m = jax_build(cfg, remat=remat)

    def loss(p, b):
        return m.loss(p, b)[0]
    fn = jax.grad(loss) if grad_only else jax.value_and_grad(loss)
    text = jax.jit(fn).lower(params, {"tokens": jnp.asarray(
        toks, jnp.int32)}).compile().as_text()
    return jhc.count(text)["flops"]


def _port_train_flops(tcfg, port, toks, remat):
    tm = build_model(tcfg, remat=remat)

    def step():
        total, _ = tm.loss(port, {"tokens": torch.tensor(toks)})
        total.backward()
    return thc.count(step)["flops"]


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_flops_equal_the_reference(remat):
    """loss and every gradient, as the reference's train step takes them
    (`value_and_grad`): equal, remat adding the layers' recomputation on
    both sides."""
    cfg, params, tcfg, port, toks = _pair("qwen3-8b")
    got = _port_train_flops(tcfg, port, toks, remat)
    assert got == _jax_train_flops(cfg, params, toks, remat)


def test_grad_only_drops_the_checkpointed_loss_forward():
    """`jax.grad` alone (no loss value) lets XLA drop the forward of the
    checkpointed loss chunk, whose value nothing reads: the reference then
    counts one logits-sized product (2 B S d V) less than its own train
    step and than the port, which reports the loss."""
    cfg, params, tcfg, port, toks = _pair("qwen3-8b")
    got = _port_train_flops(tcfg, port, toks, False)
    ref = _jax_train_flops(cfg, params, toks, False, grad_only=True)
    assert got - ref == 2 * B * S * cfg.d_model * cfg.vocab_size


# ---------------------------------------------------------------------- #
# per device under DTensor, on a fake (16, 16) mesh
# ---------------------------------------------------------------------- #

@pytest.fixture
def mesh16():
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_mesh
    assert not dist.is_initialized()
    yield fake_mesh(False, "cpu")
    dist.destroy_process_group()


def _dt(mesh, shape, placements, dtype=torch.bfloat16):
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for size, p in zip(mesh.mesh.shape, placements):
        if p.is_shard():
            local[p.dim] //= int(size)
    return DTensor.from_local(torch.empty(local, dtype=dtype), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def test_dtensor_product_counts_one_rank(mesh16):
    """x [2048, 4096] (rows over data) @ w [4096, 14336] (columns over
    data, rows over model): rank 0 does 1/256 of the logical product after
    one all-gather, not the whole 2.405e11 FLOPs a logical count gives."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = _dt(mesh16, (2048, 4096), [Shard(0), Replicate()])
        w = _dt(mesh16, (4096, 14336), [Shard(1), Shard(0)])
        got = thc.count(torch.matmul, x, w)
        with FlopCounterMode(display=False) as logical:
            torch.matmul(x, w)
    whole = 2 * 2048 * 4096 * 14336
    assert logical.get_total_flops() == whole
    assert got["flops"] == whole / 256 == 939_524_096
    assert got["collective_ops"] == {"all-gather": 1, "all-reduce": 0,
                                     "reduce-scatter": 0, "all-to-all": 0,
                                     "collective-permute": 0}
    # the all-gather's result: x's 2048 rows of one model rank's 256
    # columns of the contraction, in bf16
    assert got["collective_bytes"]["all-gather"] == int(
        thc._collective_wire_bytes("all-gather", 2048 * 256 * 2, 16))


def test_row_parallel_product_counts_its_all_reduce(mesh16):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    def row_parallel(x, w):
        y = x @ w                                   # Partial over model
        return y.redistribute(y.device_mesh, [Replicate(), Replicate()])
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = _dt(mesh16, (512, 4096), [Replicate(), Shard(1)])
        w = _dt(mesh16, (4096, 1024), [Replicate(), Shard(0)])
        got = thc.count(row_parallel, x, w)
    assert got["flops"] == 2 * 512 * 1024 * 4096 / 16
    assert got["collective_ops"]["all-reduce"] == 1
    assert sum(got["collective_ops"].values()) == 1
    assert got["collective_bytes"]["all-reduce"] == int(
        thc._collective_wire_bytes("all-reduce", 512 * 1024 * 2, 16))


def test_counter_records_bytes_and_peak():
    """Views are free, a product reads its operands and writes its result,
    and the peak holds the storages alive at once."""
    a = torch.ones(64, 32)
    b = torch.ones(32, 16)

    def fn():
        c = a @ b                  # 64*32 + 32*16 + 64*16 floats
        d = c.t()                  # a view: free
        return (d * 2).sum()       # 2 * 64*16 floats, then the sum
    with thc.Counter() as c:
        fn()
    mm = 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert c.flops == 2 * 64 * 16 * 32
    assert c.bytes == mm + 4 * 2 * 64 * 16 + 4 * (64 * 16 + 1)
    assert c.peak_bytes == 4 * (64 * 16 * 2 + 1)
    top = profile_tools.top_contributors(c.records, 1)
    assert top[0][2] == "mm" and top[0][0] == mm and top[0][1] == 1
    assert profile_tools.top_contributors(c.records, 5, "COLL") == []


def test_report_over_port_records():
    row = RooflineTerms("a", "train_4k", "16x16", 256, 1e12, 1e11,
                        {"all-gather": int(1e9)}, 1e14).row()
    recs = [{"arch": "a", "shape": "train_4k", "mesh": "16x16", "ok": True,
             "skip": None, "memory": {"total_per_device": 2.0 ** 30},
             "roofline": row},
            {"arch": "b", "shape": "long_500k", "mesh": "16x16", "ok": True,
             "skip": "why", "memory": None, "roofline": None},
            {"arch": "c", "shape": "train_4k", "mesh": "16x16", "ok": False,
             "skip": None}]
    assert report.summary(recs) == {"ok": 1, "skip": 1, "fail": 1}
    table = report.table(recs)
    assert "| a | train_4k | 1.00 |" in table and "FAILED" in table
    assert "skipped: why" in table
    assert report.worst_cells(recs)[0]["arch"] == "a"
    pairs = report.pair_table(recs + [dict(recs[0], mesh="2x16x16")])
    assert "| a | train_4k | memory 1.0 / 29.9 / 20.0 | 1.00 (1%) |" in pairs
    assert "SKIP (1): b/long_500k/16x16" in pairs
    assert "FAIL (1): c/train_4k/16x16" in pairs


# ---------------------------------------------------------------------- #
# the kernels' fake ops and FLOP formulas
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("b,h,hkv,sq,skv,d", [(2, 4, 2, 64, 64, 32),
                                              (1, 8, 1, 48, 80, 64)])
def test_fake_flash_op_matches_the_plain_version(b, h, hkv, sq, skv, d):
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, h, sq, d, generator=g)
    k = torch.randn(b, hkv, skv, d, generator=g)
    v = torch.randn(b, hkv, skv, d, generator=g)
    plain = thc.Counter()
    with plain:
        ref = kref.mha_reference(q, k, v, causal=True, window=16)
    with FakeTensorMode() as fm:
        fq, fk, fv = (fm.from_tensor(t) for t in (q, k, v))
        with thc.Counter() as kernel:
            out = torch.ops.repro_torch.flash_attention(fq, fk, fv, True, 16,
                                                        0, 0.0)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert kernel.flops == plain.flops == 4 * b * h * sq * skv * d


@pytest.mark.parametrize("g", [1, 4])
def test_fake_ssd_op_matches_the_plain_version(g):
    from torch._subclasses.fake_tensor import FakeTensorMode
    bs, h, s, p, n, q = 2, 4, 64, 16, 32, 16
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(bs, h, s, p, generator=gen)
    dt = torch.rand(bs, h, s, generator=gen)
    a = -torch.rand(bs, h, generator=gen)
    bb = torch.randn(bs, g, s, n, generator=gen)
    cc = torch.randn(bs, g, s, n, generator=gen)
    with thc.Counter() as plain:
        y, st = kref.ssd_chunk_intra_heads_reference(x, dt, a, bb, cc, q)
    with FakeTensorMode() as fm:
        fx, fdt, fa, fb, fc = (fm.from_tensor(t) for t in (x, dt, a, bb, cc))
        fy = torch.empty(y.shape, dtype=y.dtype)
        fst = torch.empty(st.shape, dtype=st.dtype)
        with thc.Counter() as kernel:
            torch.ops.repro_torch.ssd_chunk_intra_heads(fx, fdt, fa, fb, fc,
                                                        q, fy, fst)
    assert kernel.flops == plain.flops == 2 * bs * s * (
        g * q * n + h * (q * p + p * n))


@pytest.mark.parametrize("g", [1, 4])
def test_fake_ssd_backward_op_matches_the_plain_version(g):
    """The backward's custom op under fake tensors: its outputs' shapes and
    its FLOP formula, the matmul FLOPs of the plain backward."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    bs, h, s, p, n, q = 2, 4, 64, 16, 32, 16
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(bs, h, s, p, generator=gen)
    dt = torch.rand(bs, h, s, generator=gen)
    a = -torch.rand(bs, h, generator=gen)
    bb = torch.randn(bs, g, s, n, generator=gen)
    cc = torch.randn(bs, g, s, n, generator=gen)
    dy = torch.randn(bs, h, s, p, generator=gen)
    dst = torch.randn(bs, h, s // q, p, n, generator=gen)
    with thc.Counter() as plain:
        ref = kref.ssd_chunk_intra_bwd_reference(x, dt, a, bb, cc, dy, dst,
                                                 q)
    with FakeTensorMode() as fm:
        fake = [fm.from_tensor(t) for t in (x, dt, a, bb, cc, dy, dst)]
        outs = [torch.empty(t.shape, dtype=t.dtype) for t in ref]
        with thc.Counter() as kernel:
            torch.ops.repro_torch.ssd_chunk_intra_bwd(*fake[:7], q, *outs)
    assert [t.shape for t in outs] == [t.shape for t in ref]
    assert kernel.flops == plain.flops == 2 * bs * s * (
        3 * g * q * n + 2 * h * (q * p + p * n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_state_ops_match_the_plain_version(dtype):
    """The state passes' custom ops (steps 3 and 4 of the chunked SSD)
    under fake tensors: their outputs' shapes and their FLOP formulas,
    the matmul FLOPs of the plain versions (the read-out, then dE and
    dy entering)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.ssd_state import (ssd_state_bwd_heads,
                                               ssd_state_heads)
    bs, h, s, p, n, q = 2, 4, 64, 16, 32, 16
    gen = torch.Generator().manual_seed(0)
    y = torch.randn(bs, h, s, p, generator=gen).to(dtype)
    st = torch.randn(bs, h, s // q, p, n, generator=gen)
    dt = torch.rand(bs, h, s, generator=gen)
    a = -torch.rand(bs, h, generator=gen)
    c = torch.randn(bs, 1, s, n, generator=gen).to(dtype)
    dy = torch.randn(bs, h, s, p, generator=gen).to(dtype)
    with thc.Counter() as plain:
        ry, fin, ent, car, cs = kref.ssd_state_reference(y, st, dt, a, c, q)
    with thc.Counter() as plain_bwd:
        ref = kref.ssd_state_bwd_reference(dy, None, car, ent, cs, c, q)
    with FakeTensorMode() as fm:
        fake = [fm.from_tensor(t) for t in (y, st, dt, a, c, dy)]
        with thc.Counter() as kernel:
            outs = ssd_state_heads(*fake[:5], q)
        with thc.Counter() as kernel_bwd:
            grads = ssd_state_bwd_heads(fake[5], None, outs[2], outs[1],
                                        outs[3], fake[4], q)
    assert [t.shape for t in outs] == [t.shape for t in (fin, ent, car, cs)]
    assert [t.shape for t in grads] == [t.shape for t in ref]
    assert kernel.flops == plain.flops == 2 * bs * s * h * p * n
    assert kernel_bwd.flops == plain_bwd.flops == 4 * bs * s * h * p * n
