"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's ``moe_block`` on the CPU, at ``deepseek-v3-smoke`` (8 experts,
top 2, a shared expert) and ``kimi-k2-smoke`` (12 experts), with the same
weights (the reference's ``init_params`` through ``params_from_reference``)
and the same tokens.

The routing buffers are recorded from the reference's own run: its
``jax.lax.top_k`` and its ``shard`` hints (``buf_tok`` and ``buf_gate`` pass
through ``shard(..., "groups", "experts", None)``) are wrapped for the
test.  Tolerances:

* ``ids`` and ``buf_tok`` exactly: a token's experts and each slot's token;
* ``buf_gate`` and ``aux`` rtol = atol = 1e-6: float32 softmax and sums in
  another order;
* the output rtol = 1e-5, atol = 1e-6 (float32 products summed in another
  order; the combine adds in operand order, as XLA's scatter);
* gradients rtol = 1e-4, atol = 1e-6: the backward's products in another
  order, through the expert products and the softmax;
* bfloat16 activations: rtol = atol = 2e-2 at the output's scale.

Cases: random routing, ties (router columns in equal pairs: a token's two
equal experts go lower index first), capacity overflow (capacity factor
0.25: rows past C are dropped), ``groups = 2`` (routing per group) and
``groups = 3``, which does not divide the tokens (one group).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny model: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jx_get_smoke  # noqa: E402
from repro.models import moe as jx_moe  # noqa: E402
from repro.models.params import init_params as jx_init_params  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

ARCHS = ["deepseek-v3-671b", "kimi-k2-1t-a32b"]
CASES = {"random": {}, "ties": {}, "overflow": {"capacity_factor": 0.25},
         "groups2": {"groups": 2}, "groups3": {"groups": 3}}
B, S = 2, 16


def _setup(arch, case, act="float32", seed=0):
    jcfg, cfg = jx_get_smoke(arch), get_smoke(arch)
    if CASES[case]:
        jcfg = jcfg.replace(moe=jcfg.moe.__class__(**{**jcfg.moe.__dict__, **CASES[case]}))
        cfg = cfg.replace(moe=cfg.moe.__class__(**{**cfg.moe.__dict__, **CASES[case]}))
    jcfg, cfg = jcfg.replace(act_dtype=act), cfg.replace(act_dtype=act)
    jp = jx_init_params(jax.random.PRNGKey(seed), jx_moe.moe_decls(jcfg))
    if case == "ties":  # experts 2i and 2i+1 score alike for every token
        r = np.asarray(jp["router"])
        jp = {**jp, "router": jnp.asarray(np.repeat(r[:, ::2], 2, axis=1))}
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(seed + 1).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, tp, x


def _reference_routing(monkeypatch, jcfg, jp, x):
    """The reference's (out, aux) and its recorded ids, buf_tok, buf_gate."""
    seen, hinted = {}, []
    top_k = jax.lax.top_k

    def record_top_k(a, k):
        seen["gates"], seen["ids"] = top_k(a, k)
        return seen["gates"], seen["ids"]

    def record_shard(a, *axes):
        hinted.append((axes, a))
        return a

    monkeypatch.setattr(jax.lax, "top_k", record_top_k)
    monkeypatch.setattr(jx_moe, "shard", record_shard)
    out, aux = jx_moe.moe_block(jnp.asarray(x), jp, jcfg)
    bufs = [a for axes, a in hinted if axes == ("groups", "experts", None)]
    return out, aux, np.asarray(seen["ids"]), np.asarray(bufs[0]), np.asarray(bufs[1])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_the_reference(monkeypatch, arch, case):
    jcfg, cfg, jp, tp, x = _setup(arch, case)
    want, want_aux, ids, buf_tok, buf_gate = _reference_routing(monkeypatch, jcfg, jp, x)
    m = cfg.moe
    G = m.groups if (B * S) % m.groups == 0 else 1
    xt = torch.from_numpy(x).reshape(G, B * S // G, cfg.d_model)
    r = moe.route(xt, tp["router"], cfg)
    C = moe.capacity(B * S // G, cfg)
    assert C == jx_moe.capacity(B * S // G, jcfg)
    assert tuple(r.buf_tok.shape) == buf_tok.shape == (G, m.num_experts, C)
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    np.testing.assert_array_equal(r.buf_tok.numpy(), buf_tok)
    np.testing.assert_allclose(r.buf_gate.numpy(), buf_gate, rtol=1e-6, atol=1e-6)
    got, aux = moe.moe_block(torch.from_numpy(x), tp, cfg)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if case == "ties":  # a token's two equal experts: the even one first
        assert (r.ids[..., 0] % 2 == 0).all() and (r.ids[..., 1] == r.ids[..., 0] + 1).all()
    if case == "overflow":  # some rows were dropped
        assert int((r.buf_tok < B * S // G).sum()) < B * S * m.top_k


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_gradients_match_jax_grad(arch):
    jcfg, cfg, jp, tp, x = _setup(arch, "overflow", seed=2)
    w = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(params, xx):
        out, aux = jx_moe.moe_block(xx, params, jcfg)
        return jnp.sum(out * w) + aux

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.detach().requires_grad_(True) for k, v in tp.items() if k != "shared"}
    shared = {k: v.detach().requires_grad_(True) for k, v in tp["shared"].items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_block(tx, {**leaves, "shared": shared}, cfg)
    loss = torch.sum(out * torch.from_numpy(w)) + aux
    names = list(leaves) + [f"shared/{k}" for k in shared]
    grads = torch.autograd.grad(loss, list(leaves.values()) + list(shared.values()) + [tx])
    want = [want_p[k] for k in leaves] + [want_p["shared"][k] for k in shared] + [want_x]
    for name, g, ref in zip(names + ["x"], grads, want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=1e-6 * max(1.0, np.abs(
            ref).max()), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_bfloat16_activations(monkeypatch, arch):
    """bf16 activations: the dtype chain (h cast before wd, y and the combine
    in bf16) holds the reference's output to bf16 tolerance."""
    jcfg, cfg, jp, tp, x = _setup(arch, "random", act="bfloat16", seed=3)
    want, want_aux = jx_moe.moe_block(jnp.asarray(x, jnp.bfloat16), jp, jcfg)
    got, aux = moe.moe_block(torch.from_numpy(x).to(torch.bfloat16), tp, cfg)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2 * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_capacity_is_the_reference_rounding():
    cfg, jcfg = get_smoke("deepseek-v3-671b"), jx_get_smoke("deepseek-v3-671b")
    for tokens in (1, 3, 16, 17, 100, 512, 4096):
        assert moe.capacity(tokens, cfg) == jx_moe.capacity(tokens, jcfg)
        assert moe.capacity(tokens, cfg) >= 4 and moe.capacity(tokens, cfg) % 4 == 0
