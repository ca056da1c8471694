"""The port's MoE block against the JAX reference on the CPU, with the same
numpy inputs and the same weights: the grouped dense dispatch
(`moe_forward`) over groups, capacity drops and top-k ties, the weights
carried across by from_jax_params, and the expert-parallel form
(`moe_forward_alltoall`) over 8 stacked ranks against the JAX function
under shard_map on 8 forced host devices.

Tolerances, float32 throughout: outputs within 1e-5 of their largest
magnitude (the frameworks sum the products in different orders, and the
reference's init, 1/sqrt(E) for the expert tensors, gives outputs of ~50 at
these widths), the aux loss 1e-6.  Transports are compared exactly: they
only move values."""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import moe as jmoe
from repro.models.common import ModelConfig as JaxModelConfig
from repro.models.model_zoo import build_model as jax_build
from repro_torch.api import Collectives
from repro_torch.comms import Stacked, tree_all_to_all
from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_params
from repro_torch.models import moe as tmoe
from repro_torch.models.common import ModelConfig

torch.set_num_threads(1)

ATOL = 1e-5
AUX_ATOL = 1e-6
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x7b"]   # with and without shared


def close(got, ref, atol=ATOL):
    """|got - ref| <= atol * max(1, max |ref|)."""
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got.detach().float()), ref,
                               atol=atol * max(1.0, np.abs(ref).max()),
                               rtol=0)


def port_moe(cfg, tree) -> tmoe.MoE:
    """The port's MoE block with the weights of a JAX `init_moe` tree."""
    m = tmoe.MoE(cfg)
    with torch.no_grad():
        for name, w in tree.items():
            if name == "shared":
                for lin, v in w.items():
                    getattr(m.shared, lin).weight.copy_(
                        torch.tensor(np.asarray(v).T))
            else:
                getattr(m, name).copy_(torch.tensor(np.asarray(w)))
    return m


def moe_pair(name, seed=0, **overrides):
    """(jax cfg, port cfg, jax params, port MoE) with equal weights."""
    cfg_j = dataclasses.replace(jax_reduced(name), **overrides)
    cfg_t = dataclasses.replace(reduced_config(name), **overrides)
    pj = jmoe.init_moe(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, pj, port_moe(cfg_t, pj)


@pytest.fixture
def groups():
    """Sets the token groups of both packages; restores 1 after."""
    def set_both(g):
        jmoe.set_moe_groups(g)
        tmoe.set_moe_groups(g)
    yield set_both
    set_both(1)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("g", [1, 2, 3])
def test_moe_forward_matches_jax(name, g, groups):
    """20 tokens: 1 group, 2 groups of 10, and 3, which does not divide
    them and falls back to one group."""
    cfg_j, cfg_t, pj, pt = moe_pair(name)
    x = np.random.default_rng(1).standard_normal(
        (2, 10, cfg_t.d_model)).astype(np.float32)
    groups(g)
    assert tmoe.get_moe_groups() == g
    ref, aux_ref = jmoe.moe_forward(pj, cfg_j, jnp.asarray(x))
    got, aux = tmoe.moe_forward(pt, cfg_t, torch.from_numpy(x))
    assert got.shape == x.shape and aux.dtype == torch.float32
    close(got, ref)
    close(aux, aux_ref, AUX_ATOL)


def test_moe_group_fallback_equals_one_group(groups):
    """The port's counterpart of tests/test_models.py's fallback test: 3
    groups over 20 tokens is bit-equal to the ungrouped forward."""
    _, cfg, _, p = moe_pair("qwen2-moe-a2.7b")
    x = torch.randn(1, 20, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    base, aux_base = tmoe.moe_forward(p, cfg, x)
    groups(3)
    y, aux = tmoe.moe_forward(p, cfg, x)
    assert torch.equal(y, base) and torch.equal(aux, aux_base)


def _tiny(pkg_config, **kw):
    return pkg_config(name="tiny-moe", family="moe", num_layers=1,
                      d_model=8, num_heads=2, num_kv_heads=2, d_ff=16,
                      vocab_size=32, num_experts=4, num_experts_per_tok=2,
                      moe_d_ff=16, num_shared_experts=0, **kw)


def test_moe_capacity_overflow_drops_tokens():
    """cap = ceil(8*2*0.1/4) = 1: identical tokens all route to the same two
    experts, so only the first token wins a slot; every later token lands
    in the overflow slot and contributes exactly zero, as in the reference
    (tests/test_models.py); with drop-free capacity every token gets the
    first token's output."""
    cfg_j = _tiny(JaxModelConfig, capacity_factor=0.1)
    cfg = _tiny(ModelConfig, capacity_factor=0.1)
    pj = jmoe.init_moe(jax.random.PRNGKey(0), cfg_j)
    p = port_moe(cfg, pj)
    one = np.random.default_rng(3).standard_normal((1, 1, 8))
    x = np.broadcast_to(one, (1, 8, 8)).astype(np.float32)
    y, aux = tmoe.moe_forward(p, cfg, torch.from_numpy(x.copy()))
    assert bool((y[0, 0] != 0).any())
    assert torch.equal(y[0, 1:], torch.zeros(7, 8))
    assert torch.isfinite(aux)
    ref, aux_ref = jmoe.moe_forward(pj, cfg_j, jnp.asarray(x))
    close(y, ref)
    close(aux, aux_ref, AUX_ATOL)
    cfg_full = _tiny(ModelConfig, capacity_factor=16.0)
    y_full, _ = tmoe.moe_forward(p, cfg_full, torch.from_numpy(x.copy()))
    torch.testing.assert_close(y_full[0, 1:], y_full[0, :1].expand(7, 8),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(y_full[0, 0], y[0, 0], rtol=0, atol=1e-6)


def test_moe_top_k_tie_picks_the_lower_index():
    """Experts 1 and 2 have the same router column, so every token's
    probabilities tie exactly at the k-th (second) place: the reference's
    top_k takes expert 1, and so must the port."""
    cfg_j, cfg = _tiny(JaxModelConfig), _tiny(ModelConfig)
    pj = jmoe.init_moe(jax.random.PRNGKey(4), cfg_j)
    router = np.zeros((8, 4), np.float32)
    router[:, 0], router[:, 1], router[:, 2], router[:, 3] = 0.5, 0.1, 0.1, -1
    pj = dict(pj, router=jnp.asarray(router))
    p = port_moe(cfg, pj)
    x = (np.abs(np.random.default_rng(5).standard_normal((1, 6, 8)))
         + 0.1).astype(np.float32)
    xt = torch.from_numpy(x)
    probs, weights, onehot, slot = tmoe._route(p, cfg, xt.view(1, 6, 8), 8)
    assert torch.equal(probs[..., 1], probs[..., 2])
    picked = onehot.view(6, 2, 4).argmax(-1)
    assert picked.tolist() == [[0, 1]] * 6
    y, aux = tmoe.moe_forward(p, cfg, xt)
    ref, aux_ref = jmoe.moe_forward(pj, cfg_j, jnp.asarray(x))
    close(y, ref)
    close(aux, aux_ref, AUX_ATOL)


@pytest.mark.parametrize("name", ARCHS)
def test_from_jax_params_carries_the_moe_leaves(name):
    """Expert tensors, router and shared_gate keep their layout; the shared
    expert's nn.Linear weights are transposed; every layer's slice."""
    cfg_j, cfg_t = jax_reduced(name), reduced_config(name)
    tree = jax.tree.map(np.asarray, jax_build(cfg_j).init(
        jax.random.PRNGKey(0)))
    pt = from_jax_params(cfg_t, tree, device="cpu")
    moe = tree["layers"]["moe"]
    for i, layer in enumerate(pt.layers):
        assert not hasattr(layer, "mlp")
        for key in ("router", "w_gate", "w_up", "w_down", "shared_gate"):
            if key in moe:
                np.testing.assert_array_equal(
                    getattr(layer.moe, key).detach().numpy(), moe[key][i])
        for lin, w in moe.get("shared", {}).items():
            np.testing.assert_array_equal(
                getattr(layer.moe.shared, lin).weight.detach().numpy(),
                w[i].T)
    assert hasattr(pt.layers[0].moe, "shared") == bool(
        cfg_t.num_shared_experts)
    names = {n for n, _ in pt.named_parameters()}
    assert "layers.0.moe.w_gate" in names and "layers.0.moe.router" in names


# ---------------------------------------------------------------------- #
# expert parallel over 8 stacked ranks vs JAX under shard_map
# ---------------------------------------------------------------------- #

A2A_CASES = {"plain": 0, "shared": 1}     # num_shared_experts

JAX_A2A = """
import sys
import numpy as np
import jax, jax.numpy as jnp
try:
    from jax import shard_map
except ImportError:  # older jax: experimental namespace
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.api import Collectives
from repro.comms import tree_all_to_all
from repro.models.common import ModelConfig
from repro.models.moe import init_moe, moe_forward_alltoall

data = np.load(sys.argv[1])
mesh = Mesh(np.array(jax.devices()), ('x',))
prog = Collectives(num_chunks=1).program('bring:8', kind='alltoall')
out = {}
for case, shared in (('plain', 0), ('shared', 1)):
    cfg = ModelConfig(name='t', family='moe', num_layers=1, d_model=16,
                      num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64,
                      num_experts=8, num_experts_per_tok=2, moe_d_ff=24,
                      num_shared_experts=shared, capacity_factor=2.0)
    p = init_moe(jax.random.PRNGKey(shared), cfg)
    for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
        out[case + '/w/' + '/'.join(e.key for e in k)] = np.asarray(v)
    x = jnp.asarray(data['x'])
    for tag, a2a in (('lax', None),
                     ('tree', lambda u: tree_all_to_all(u, prog, 'x'))):
        def body(v, a2a=a2a):
            y, aux = moe_forward_alltoall(p, cfg, v, 'x', all_to_all=a2a)
            return y, aux[None]
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=P('x'),
                              out_specs=(P('x'), P('x'))))
        y, aux = f(x)
        out[f'{case}/{tag}/y'] = np.asarray(y)
        out[f'{case}/{tag}/aux'] = np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def a2a_io(tmp_path_factory):
    """Inputs [8 ranks * 2, 6, 16] and the JAX outputs and weights of both
    cases, from one subprocess with 8 forced host devices."""
    d = tmp_path_factory.mktemp("moe_a2a")
    x = np.random.default_rng(6).standard_normal((16, 6, 16)).astype(
        np.float32)
    np.savez(d / "in.npz", x=x)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", JAX_A2A, str(d / "in.npz"),
                          str(d / "out.npz")], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return x, dict(np.load(d / "out.npz"))


def _a2a_cfg(shared):
    return ModelConfig(name="t", family="moe", num_layers=1, d_model=16,
                       num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64,
                       num_experts=8, num_experts_per_tok=2, moe_d_ff=24,
                       num_shared_experts=shared, capacity_factor=2.0)


@pytest.mark.parametrize("case", sorted(A2A_CASES))
def test_moe_forward_alltoall_stacked_matches_jax(a2a_io, case):
    x, ref = a2a_io
    cfg = _a2a_cfg(A2A_CASES[case])
    prefix = f"{case}/w/"
    tree = {}
    for key, v in ref.items():
        if key.startswith(prefix):
            *outer, leaf = key[len(prefix):].split("/")
            (tree.setdefault(outer[0], {}) if outer else tree)[leaf] = v
    p = port_moe(cfg, tree)
    comm = Stacked(8)
    prog = Collectives(num_chunks=1).program("bring:8", kind="alltoall")
    xs = torch.from_numpy(x).view(8, 2, 6, 16)
    y, aux = tmoe.moe_forward_alltoall(p, cfg, xs, comm)
    y_tree, aux_tree = tmoe.moe_forward_alltoall(
        p, cfg, xs, comm,
        all_to_all=functools.partial(tree_all_to_all, prog=prog, comm=comm))
    assert torch.equal(y, y_tree) and torch.equal(aux, aux_tree)
    np.testing.assert_array_equal(ref[f"{case}/lax/y"], ref[f"{case}/tree/y"])
    close(y.reshape(16, 6, 16), ref[f"{case}/lax/y"])
    close(aux, ref[f"{case}/lax/aux"], AUX_ATOL)
    # tokens stay data-parallel: each rank equals its own dense dispatch
    for r in range(8):
        y_loc, aux_loc = tmoe.moe_forward(p, cfg, xs[r])
        close(y[r], y_loc.detach().numpy())
        close(aux[r], aux_loc.detach().numpy(), AUX_ATOL)


def test_moe_forward_alltoall_refuses_uneven_experts():
    cfg = dataclasses.replace(_a2a_cfg(0), num_experts=12)
    with pytest.raises(ValueError, match="not divisible"):
        tmoe.moe_forward_alltoall(tmoe.MoE(cfg), cfg,
                                  torch.zeros(8, 1, 2, 16), Stacked(8))


@pytest.mark.parametrize("remat", [False, True])
def test_decoder_stack_sums_the_moe_aux_like_jax(remat):
    """decoder_stack returns the layers' summed aux as the reference's does
    (serving discards it; MoE training will add 0.01 times it), also through
    the per-layer recomputation."""
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as ttf
    name = "qwen2-moe-a2.7b"
    cfg_j, cfg_t = jax_reduced(name), reduced_config(name)
    tree = jax.tree.map(np.asarray, jax_build(cfg_j).init(
        jax.random.PRNGKey(1)))
    pt = from_jax_params(cfg_t, tree, device="cpu")
    tokens = np.random.default_rng(7).integers(1, cfg_t.vocab_size, (2, 12))
    pj = jax.tree.map(jnp.asarray, tree)
    h_j = jtf.embed_tokens(pj, cfg_j, jnp.asarray(tokens))
    _, _, aux_ref = jtf.decoder_stack(pj, cfg_j, h_j, jnp.arange(12))
    h_t = ttf.embed_tokens(pt, cfg_t, torch.from_numpy(tokens))
    _, _, aux = ttf.decoder_stack(pt, cfg_t, h_t, None, remat=remat)
    assert aux.shape == () and aux.dtype == torch.float32
    close(aux, aux_ref, AUX_ATOL)
