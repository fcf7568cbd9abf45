"""The port's WKV-6 recurrence (``repro_torch.kernels.ref.wkv6`` and
``wkv6_chunked``, and the ``ops.wkv6`` wrapper) against the JAX package's
sequential oracle, its chunked jnp version and its Pallas kernel in
interpret mode, on the CPU.

Tolerances are the reference's own (``tests/test_kernels.py``): 3e-4 in
float32, where the chunked log-space algebra and the sequential scan sum in
different orders, and 2e-2 for bfloat16 inputs.  The CUDA kernel itself is
held against ``ref.wkv6_chunked`` on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: more threads only contend with the other test workers

import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.wkv6 import wkv6 as pallas_wkv6  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

F32_TOL = dict(rtol=3e-4, atol=3e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SHAPES = [  # (T, H, K, V, chunk): the reference's five, then a ragged T
    (8, 1, 8, 8, 8), (16, 2, 8, 16, 8), (33, 1, 16, 16, 16),
    (64, 3, 32, 64, 32), (100, 2, 64, 64, 32), (37, 2, 16, 16, 32),
]


def _case(T, H, K, V, seed=0, strong_decay=True):
    """The reference's ``_wkv_case``: r, k, v, w, u, s0 as float32 numpy."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(T, H, K)).astype(np.float32)
    k = (rng.normal(size=(T, H, K)) * 0.5).astype(np.float32)
    v = rng.normal(size=(T, H, V)).astype(np.float32)
    scale = 1.0 if strong_decay else 0.1
    w = np.exp(-np.exp(rng.normal(size=(T, H, K)) * scale)).astype(np.float32)
    u = (rng.normal(size=(H, K)) * 0.3).astype(np.float32)
    s0 = (rng.normal(size=(H, K, V)) * 0.2).astype(np.float32)
    return r, k, v, w, u, s0


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(port, jax_out, tol):
    for a, b in zip(port, jax_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("T,H,K,V,chunk", SHAPES)
def test_plain_versions_match_the_reference(T, H, K, V, chunk):
    args = _case(T, H, K, V)
    seq = jref.wkv6(*map(jnp.asarray, args))
    _close(ref.wkv6(*_t(args)), seq, F32_TOL)
    _close(ref.wkv6_chunked(*_t(args), chunk=chunk),
           jref.wkv6_chunked(*map(jnp.asarray, args), chunk=chunk), F32_TOL)
    _close(ref.wkv6_chunked(*_t(args), chunk=chunk), seq, F32_TOL)
    _close(ref.wkv6_chunked(*_t(args), chunk=chunk),
           pallas_wkv6(*map(jnp.asarray, args), chunk=chunk, interpret=True), F32_TOL)


def test_plain_versions_without_a_state_and_with_weak_decay():
    r, k, v, w, u, _ = _case(45, 2, 16, 16, seed=3, strong_decay=False)
    seq = jref.wkv6(*map(jnp.asarray, (r, k, v, w, u)))
    _close(ref.wkv6_chunked(*_t((r, k, v, w, u)), chunk=16), seq, F32_TOL)
    _close(ref.wkv6(*_t((r, k, v, w, u))), seq, F32_TOL)


def test_bf16_inputs():
    """bfloat16 r, k, v, w, u (the reference's bf16 case), float32 inside."""
    r, k, v, w, u, s0 = _case(32, 2, 16, 16)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v, w, u)]
    pt = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v, w, u)]
    want = pallas_wkv6(*jx, jnp.asarray(s0), chunk=16, interpret=True)
    _close(ref.wkv6_chunked(*pt, torch.from_numpy(s0), chunk=16), want, BF16_TOL)
    _close(ref.wkv6(*pt, torch.from_numpy(s0)), jref.wkv6(*jx, jnp.asarray(s0)), BF16_TOL)


def test_chunk_one_is_the_closed_form():
    args = _case(1, 2, 8, 8)
    _close(ref.wkv6_chunked(*_t(args), chunk=1), ref.wkv6(*_t(args)),
           dict(rtol=1e-5, atol=1e-5))


def test_state_continuity():
    """[0:20] then [20:40] from the carried state equals one pass."""
    r, k, v, w, u, s0 = _t(_case(40, 2, 16, 16))
    o_full, s_full = ref.wkv6_chunked(r, k, v, w, u, s0, chunk=8)
    o_a, s_a = ref.wkv6_chunked(r[:20], k[:20], v[:20], w[:20], u, s0, chunk=8)
    o_b, s_b = ref.wkv6_chunked(r[20:], k[20:], v[20:], w[20:], u, s_a, chunk=8)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(o_full.numpy(), torch.cat([o_a, o_b]).numpy(), **tol)
    np.testing.assert_allclose(s_full.numpy(), s_b.numpy(), **tol)


def test_batched_equals_each_sequence():
    """A leading batch, as the time mix calls it, runs each sequence alone."""
    cases = [_case(37, 2, 16, 16, seed=s) for s in range(3)]
    stacked = [torch.from_numpy(np.stack(parts)) for parts in zip(*cases)]
    r, k, v, w, _, s0 = stacked
    u = stacked[4][0]
    o, s = ref.wkv6_chunked(r, k, v, w, u, s0)
    for i, (ri, ki, vi, wi, _, si) in enumerate(cases):
        oi, sfi = ref.wkv6_chunked(*_t((ri, ki, vi, wi)), u, torch.from_numpy(si))
        assert torch.equal(o[i], oi) and torch.equal(s[i], sfi)


def test_wrapper_on_cpu_runs_the_plain_version():
    cases = [_case(37, 2, 16, 16, seed=s) for s in range(2)]
    r, k, v, w, _, s0 = (torch.from_numpy(np.stack(p)) for p in zip(*cases))
    u = torch.from_numpy(cases[0][4])
    ops.reset_launch_counts()
    for state in (None, s0):
        o, s = ops.wkv6(r, k, v, w, u, state)
        o_ref, s_ref = ref.wkv6_chunked(r, k, v, w, u, state)
        assert torch.equal(o, o_ref) and torch.equal(s, s_ref)
        assert o.dtype == s.dtype == torch.float32
    for i, (ri, ki, vi, wi, _, si) in enumerate(cases):
        want = jref.wkv6(*map(jnp.asarray, (ri, ki, vi, wi, cases[0][4], si)))
        _close((o[i], s[i]), want, F32_TOL)
    assert ops.launch_counts()["wkv6"] == 0


def test_wrapper_on_cuda_tensors_never_falls_back(monkeypatch):
    """CUDA tensors launch the kernel or raise: with no GPU visible the
    wrapper raises, and never runs the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(ref, "wkv6_chunked", no_plain)
    with FakeTensorMode():
        r = torch.zeros((1, 5, 2, 8), device="cuda")
        u = torch.zeros((2, 8), device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.wkv6(r, r, r, r, u)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        meta = torch.zeros((1, 5, 2, 8), device="meta")
        ops.wkv6(meta, meta, meta, meta, torch.zeros((2, 8), device="meta"))


@pytest.mark.parametrize("T,K,chunk", [(40, 8, 64), (5, 80, 32)], ids=["long_chunk", "wide_k"])
def test_wrapper_rejects_shapes_past_the_kernel_tile(T, K, chunk):
    """The kernel works a chunk as one tile of at most 32 tokens by 64 keys:
    CUDA tensors past it raise before any launch."""
    with FakeTensorMode():
        r = torch.zeros((1, T, 2, K), device="cuda")
        u = torch.zeros((2, K), device="cuda")
        with pytest.raises(ValueError, match="at most 32 tokens"):
            ops.wkv6(r, r, r, r, u, chunk=chunk)
