"""The port's MoE MLP (``models/moe.py``) against the JAX ``moe_apply``.

Same numpy inputs, same parameters (the JAX ``moe_init`` tree, converted),
fp32 on the CPU. The dispatch tables (``tok_idx``, ``weight``) of the same
expert ids and gates are exactly equal; the outputs and the auxiliary loss
agree within 1e-5 (fp32, other summation orders in the products). Cases:
softmax and sigmoid routers, K = 1 and 4, with and without
``router_norm_topk`` and shared experts, and dropping at a capacity factor
below 1. The invariants of ``tests/test_moe_dispatch.py`` are ported as
cases over fixed seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe

TOL = 1e-5
CASES = {
    "softmax_k4_shared": {},
    "sigmoid_k1": dict(router_act="sigmoid", router_norm_topk=False,
                       top_k=1),
    "softmax_k1": dict(top_k=1),
    "k4_unnormed_no_shared": dict(router_norm_topk=False,
                                  n_shared_experts=0),
    "drops_cf_half": dict(capacity_factor=0.5),
    "sigmoid_k4_normed": dict(router_act="sigmoid"),
}


@pytest.fixture(autouse=True)
def _auto_mesh():
    """The JAX calls under a one-device mesh of Auto axes: a global mesh
    that another test in this process set with ``jax.set_mesh`` (Explicit
    axes by default) would otherwise reach them (``jnp.repeat`` in the
    dispatch tables then asks for an ``out_sharding``)."""
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _cfgs(**over):
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen2-moe-a2.7b"), **over)
    tcfg = dataclasses.replace(configs.get_smoke("qwen2-moe-a2.7b"),
                               dtype=torch.float32, **over)
    return jcfg, tcfg


def _port_params(jp: dict) -> dict:
    flat = {k: jp[k] for k in ("router", "gate", "up", "down")}
    if "shared" in jp:
        flat |= {f"shared_{k}": v for k, v in jp["shared"].items()}
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _jax_tables(idx, gates, E, S, K, C):
    tok, w = _tables_jit(jnp.asarray(idx), jnp.asarray(gates), E, S, K, C)
    return np.asarray(tok), np.asarray(w)


_tables_jit = jax.jit(
    lambda i, g, E, S, K, C: jax.vmap(
        lambda a, b: jmoe._dispatch_tables(a, b, E, S, K, C))(i, g),
    static_argnums=(2, 3, 4, 5))


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_jax(case):
    jcfg, tcfg = _cfgs(**CASES[case])
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(0).standard_normal((3, 24, 128)).astype(
        np.float32)
    out, aux = jax.jit(jmoe.moe_apply, static_argnums=2)(
        jp, jnp.asarray(x), jcfg)
    tout, taux = moe.moe_apply(_port_params(jp), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(taux), float(aux), rtol=TOL, atol=0)
    # the tables of the JAX router's own top-k, exactly
    logits = (jnp.asarray(x) @ jp["router"]).astype(jnp.float32)
    probs = (jax.nn.sigmoid(logits) if jcfg.router_act == "sigmoid"
             else jax.nn.softmax(logits, -1))
    gates, idx = jax.lax.top_k(probs, jcfg.top_k)
    if jcfg.router_norm_topk and jcfg.top_k > 1:
        gates = gates / jnp.sum(gates, -1, keepdims=True)
    E, S, K = jcfg.n_experts, x.shape[1], jcfg.top_k
    C = jmoe.capacity(jcfg, S)
    assert moe.capacity(tcfg, S) == C
    want_tok, want_w = _jax_tables(idx, gates, E, S, K, C)
    tok, w, slot_of = moe.dispatch_tables(
        torch.from_numpy(np.array(idx)).long(),
        torch.from_numpy(np.array(gates)), E, C)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_array_equal(w.numpy(), want_w)
    # every assignment's slot holds its token, or it was dropped
    B = x.shape[0]
    flat = slot_of.reshape(B, S * K).numpy()
    for b in range(B):
        for s in range(S):
            for c in slot_of[b, s].numpy():
                assert c == E * C or tok[b, c] == s
    kept = (flat < E * C).sum()
    assert kept == (tok.numpy() < S).sum()
    if case == "drops_cf_half":
        assert kept < B * S * K


def test_capacity_depends_on_the_call_length():
    _, cfg = _cfgs()
    # prefill of S tokens: S·K/E·cf; a decode step (S = 1): K
    assert moe.capacity(cfg, 64) == int(64 * 4 / 8 * 1.25)
    assert moe.capacity(cfg, 1) == cfg.top_k
    full = configs.get("qwen2-moe-a2.7b")
    assert moe.capacity(full, 1) * full.n_experts == 256


@pytest.mark.parametrize("seed", range(12))
def test_dispatch_tables_invariants(seed):
    """tests/test_moe_dispatch.py::test_dispatch_tables_invariants over
    fixed draws of (E, K, S)."""
    rng = np.random.default_rng(seed)
    E, K, S = int(rng.integers(2, 17)), int(rng.integers(1, 5)), \
        int(rng.integers(4, 33))
    K = min(K, E)
    idx = rng.integers(0, E, (1, S, K))
    gates = rng.random((1, S, K)).astype(np.float32)
    C = max(int(S * K / E * 1.25), K)
    tok, w, _ = moe.dispatch_tables(torch.from_numpy(idx),
                                    torch.from_numpy(gates), E, C)
    want_tok, want_w = _jax_tables(idx, gates, E, S, K, C)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_array_equal(w.numpy(), want_w)
    tok = tok.numpy().reshape(E, C)
    w = w.numpy().reshape(E, C)
    assert (w[tok == S] == 0).all()                 # sentinel: zero weight
    assert ((tok < S).sum(axis=1) <= C).all()       # capacity respected
    for e in range(E):
        for c in range(C):
            if tok[e, c] < S:
                assert w[e, c] in gates[0, tok[e, c]]


def test_no_drop_recovers_dense_mixture():
    _, cfg = _cfgs(capacity_factor=64.0, n_shared_experts=0)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    out, _ = moe.moe_apply(p, x, cfg)
    probs = torch.softmax(x @ p["router"], -1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    g = torch.einsum("bsd,edf->bsef", x, p["gate"])
    u = torch.einsum("bsd,edf->bsef", x, p["up"])
    y_all = torch.einsum("bsef,efd->bsed", torch.nn.functional.silu(g) * u,
                         p["down"])
    mask = (torch.nn.functional.one_hot(idx, cfg.n_experts)
            * gates[..., None]).sum(2)
    ref = torch.einsum("bsed,bse->bsd", y_all, mask)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_capacity_dropping_actually_drops():
    _, cfg = _cfgs(capacity_factor=0.1, n_shared_experts=0)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    x = torch.randn((1, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    out, _ = moe.moe_apply(p, x, cfg)
    assert (torch.linalg.norm(out[0], dim=-1) == 0).any()


def test_aux_loss_balanced_is_small():
    _, cfg = _cfgs()
    p = moe.moe_init(torch.Generator().manual_seed(1), cfg, torch.float32,
                     "cpu")
    p["router"] = torch.zeros_like(p["router"])
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    _, aux = moe.moe_apply(p, x, cfg)
    assert float(aux) == pytest.approx(moe.AUX_LOSS_W, rel=0.3)


def test_param_count_and_shapes_match_jax():
    for name in ("qwen2-moe-a2.7b",):
        jc, tc = jconfigs.get(name), configs.get(name)
        for active in (False, True):
            assert moe.moe_param_count(tc, active) == \
                jmoe.moe_param_count(jc, active)
        shapes = jax.eval_shape(lambda k: jmoe.moe_init(k, jc),
                                jax.random.PRNGKey(0))
        got = moe.moe_shapes(tc)
        assert got["router"] == shapes["router"].shape
        for k in ("gate", "up", "down"):
            assert got[k] == shapes[k].shape
            assert got[f"shared_{k}"] == shapes["shared"][k].shape


@pytest.mark.parametrize("experts", [None, (2, 6)])
def test_dispatch_backward_equals_the_gathers(experts):
    """The dispatch's backward (``moe._Dispatch``: each token's slot
    gradients summed by a gather in ascending slot order, the same sum on
    every run where the card's scatter-add would use atomics) equals the
    gather's own backward bitwise on the CPU, whose scatter-add adds in
    the same order; with drops at capacity, and for one model rank's
    share of the slots (experts [2, 6) of 8)."""
    B, S, K, E, C, d = 2, 24, 3, 8, 5, 16
    g = torch.Generator().manual_seed(4)
    idx = torch.topk(torch.randn(B, S, E, generator=g), K, dim=-1)[1]
    tok_idx, _, slot_of = moe.dispatch_tables(idx, torch.ones(B, S, K), E, C)
    assert int((slot_of == E * C).sum()) > 0             # drops
    if experts is not None:
        lo, hi = experts
        n = (hi - lo) * C
        tok_idx = tok_idx[:, lo * C:hi * C]
        slot_of = slot_of - lo * C
        slot_of = torch.where((slot_of >= 0) & (slot_of < n), slot_of, n)
    x = torch.randn(B, S, d, generator=g)
    dy = torch.randn(B, tok_idx.shape[1], d, generator=g)
    a = x.clone().requires_grad_(True)
    moe._Dispatch.apply(a, tok_idx, slot_of).backward(dy)
    b = x.clone().requires_grad_(True)
    pad = torch.cat([b, b.new_zeros((B, 1, d))], 1)
    pad.gather(1, tok_idx[..., None].expand(-1, -1, d)).backward(dy)
    assert torch.equal(a.grad, b.grad)
