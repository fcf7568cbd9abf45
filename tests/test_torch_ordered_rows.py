"""The port's operand-order row scatter (``kernels.ops.ordered_rows_add``) and
the autograd functions built on it (``ordered_gather``,
``ordered_scatter_rows``, ``models.layers.embed_lookup``), on the CPU.

The plain version is held to ``np.add.at`` bit for bit: float32, float64,
and bfloat16 rounded after every add (ml_dtypes' ``np.add.at``), with rows
out of range dropped.  The gradient of ``embed_lookup`` is held to
``jax.grad`` of the reference's ``table[tokens]`` bit for bit: XLA's CPU
scatter-add folds each row in operand order, as ``np.add.at`` does (checked
here against ``np.add.at`` too), so the tolerance is 0.  The CUDA kernel
itself runs only on the card (``chip_smoke.py`` holds it to this plain
version bit for bit); here the wrapper's refusals are checked on fake CUDA
tensors.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny tensors: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.layers import embed_lookup  # noqa: E402

DTYPES = {"float32": (torch.float32, np.float32), "float64": (torch.float64, np.float64),
          "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16)}
# (targets, rows, row shape, lowest index, highest index + 1)
SHAPES = [(50, 400, (7,), -5, 60), (3, 1_000, (1,), 0, 3), (129, 64, (2, 5), -1, 140),
          (1, 300, (33,), 0, 1), (40, 0, (4,), 0, 40), (6, 50, (16,), 10, 20)]


def _torch(a, dtype):
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _add_at(out, index, source):
    want = out.copy()
    keep = (index >= 0) & (index < len(out))
    np.add.at(want, index[keep], source[keep])
    return want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", range(len(SHAPES)), ids=lambda i: "x".join(
    map(str, SHAPES[i][:2])))
def test_plain_ordered_rows_add_is_np_add_at(dtype, shape):
    n, e, row, lo, hi = SHAPES[shape]
    tdt, ndt = DTYPES[dtype]
    rng = np.random.default_rng(shape)
    out = rng.normal(size=(n, *row)).astype(ndt)
    out[0] = -0.0  # signed zeros survive where no row lands
    index = rng.integers(lo, hi, size=e)
    source = (rng.normal(size=(e, *row)) * 10.0 ** rng.integers(-3, 4, size=(e,) + (1,) *
                                                                 len(row))).astype(ndt)
    want = _torch(_add_at(out, index, source), tdt)
    for index_dtype in (torch.int64, torch.int32):
        got = ops.ordered_rows_add(_torch(out, tdt), torch.from_numpy(index).to(index_dtype),
                                   _torch(source, tdt))
        assert got.dtype == tdt and np.array_equal(_bits(got), _bits(want))


def test_bfloat16_rounds_after_every_add():
    """1 + 2⁻⁸ + 2⁻⁸ is 1 + 2⁻⁷, a bfloat16, but rounded after every add
    each 2⁻⁸ alone rounds away (a tie, to even) and the sum stays 1."""
    out = torch.ones((1, 1), dtype=torch.bfloat16)
    src = torch.full((2, 1), 2.0 ** -8, dtype=torch.bfloat16)
    got = ops.ordered_rows_add(out, torch.zeros(2, dtype=torch.int64), src)
    assert float(got) == 1.0
    assert float(ref.ordered_rows_add(torch.ones((1, 1)), torch.zeros(2, dtype=torch.int64),
                                      src.float())) == 1.0 + 2.0 ** -7


def test_plain_version_folds_in_operand_order():
    """Large and small rows into one target: the order decides the sum."""
    src = torch.tensor([[1e8], [1.0], [-1e8], [1.0]], dtype=torch.float32)
    for perm in ([0, 1, 2, 3], [1, 3, 0, 2], [0, 2, 1, 3]):
        got = ops.ordered_rows_add(torch.zeros((1, 1)), torch.zeros(4, dtype=torch.int64),
                                   src[perm])
        want = np.zeros((1, 1), np.float32)
        np.add.at(want, np.zeros(4, np.int64), src[perm].numpy())
        assert float(got) == float(want[0, 0])


REJECTED = {
    "int8 out": ((8, 4), torch.int8, torch.int8, torch.int64, TypeError),
    "mixed dtypes": ((8, 4), torch.float32, torch.bfloat16, torch.int64, TypeError),
    "float index": ((8, 4), torch.float32, torch.float32, torch.float32, TypeError),
    "row shape": ((8, 5), torch.float32, torch.float32, torch.int64, ValueError),
}


@pytest.mark.parametrize("case", REJECTED)
def test_wrapper_rejects_what_the_kernel_cannot_take(case):
    """On (fake) CUDA tensors the wrapper raises before any launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape, out_dtype, source_dtype, index_dtype, error = REJECTED[case]
    with FakeTensorMode():
        out = torch.zeros(shape, dtype=out_dtype, device="cuda")
        index = torch.zeros(10, dtype=index_dtype, device="cuda")
        source = torch.zeros((10, 4), dtype=source_dtype, device="cuda")
        with pytest.raises(error):
            ops.ordered_rows_add(out, index, source)


def test_wrapper_launches_nothing_without_rows_or_targets():
    from torch._subclasses.fake_tensor import FakeTensorMode

    ops.reset_launch_counts()
    with FakeTensorMode():
        for n, e in ((0, 10), (10, 0)):
            out = torch.zeros((n, 4), device="cuda")
            ops.ordered_rows_add(out, torch.zeros(e, dtype=torch.int64, device="cuda"),
                                 torch.zeros((e, 4), device="cuda"))
    assert ops.launch_counts()["ordered_rows_add"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab,d,batch,seq", [(50, 16, 4, 500), (512, 64, 2, 48)])
def test_embed_lookup_gradient_is_jax_grad_bit_for_bit(dtype, vocab, d, batch, seq):
    """Many repeated tokens (a tenth of the vocabulary in use): the gradient
    of ``embed_lookup`` equals ``jax.grad`` of the reference's
    ``table[tokens]`` bit for bit, and both equal ``np.add.at``."""
    tdt, ndt = DTYPES[dtype]
    rng = np.random.default_rng(vocab)
    table = rng.normal(size=(vocab, d)).astype(ndt)
    toks = rng.integers(0, max(vocab // 10, 1), size=(batch, seq)).astype(np.int32)
    g = rng.normal(size=(batch, seq, d)).astype(ndt)

    def f(t, tk, w):
        return jnp.sum((jnp.asarray(t)[tk] * w).astype(jnp.float32))

    want = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(table), jnp.asarray(toks),
                                           jnp.asarray(g)))
    assert np.array_equal(want, _add_at(np.zeros_like(table), toks.reshape(-1),
                                        g.reshape(-1, d)))
    t = _torch(table, tdt).requires_grad_(True)
    rows = embed_lookup(torch.from_numpy(toks), t)
    assert torch.equal(rows.detach(), _torch(table, tdt)[torch.from_numpy(toks).long()])
    (grad,) = torch.autograd.grad(rows, t, _torch(g, tdt))
    assert grad.dtype == tdt and np.array_equal(_bits(grad), _bits(_torch(want, tdt)))


def test_embed_lookup_forward_is_the_reference_embedding():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(30, 8)).astype(np.float32)
    toks = rng.integers(0, 30, size=(3, 7)).astype(np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(toks)])
    assert np.array_equal(embed_lookup(torch.from_numpy(toks), torch.from_numpy(table)).numpy(),
                          want)


def test_ordered_gather_and_scatter_rows_out_of_range():
    """An index out of range gathers zeros and takes no gradient; the
    scatter drops its row, and the scatter's gradient gathers zeros there."""
    table = torch.arange(12.0).reshape(4, 3).requires_grad_(True)
    index = torch.tensor([2, -1, 4, 2, 0])
    rows = ops.ordered_gather(table, index)
    assert torch.equal(rows[1], torch.zeros(3)) and torch.equal(rows[2], torch.zeros(3))
    assert torch.equal(rows[0], table[2].detach())
    (grad,) = torch.autograd.grad(rows, table, torch.ones(5, 3))
    assert torch.equal(grad, torch.tensor([[1.0] * 3, [0.0] * 3, [2.0] * 3, [0.0] * 3]))

    src = torch.arange(15.0).reshape(5, 3).requires_grad_(True)
    out = ops.ordered_scatter_rows(4, index, src)
    assert torch.equal(out, torch.tensor([[12.0, 13, 14], [0, 0, 0], [9, 11, 13], [0, 0, 0]]))
    up = torch.arange(12.0).reshape(4, 3)
    (gsrc,) = torch.autograd.grad(out, src, up)
    assert torch.equal(gsrc, torch.stack([up[2], torch.zeros(3), torch.zeros(3), up[2], up[0]]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_rows_and_its_gradient_match_the_reference_combine(dtype):
    """The MoE combine's scatter (``zeros.at[buf_tok].add(y)``, pad row
    sliced away) and its gradient against JAX, bit for bit."""
    tdt, ndt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    tg, slots, d = 9, 40, 6
    buf_tok = rng.integers(0, tg + 1, size=slots).astype(np.int32)  # tg: the pad token
    y = rng.normal(size=(slots, d)).astype(ndt)
    up = rng.normal(size=(tg, d)).astype(ndt)

    def combine(yy, bt):
        return jnp.zeros((tg + 1, d), yy.dtype).at[bt].add(yy)[:tg]

    want = np.asarray(jax.jit(combine)(jnp.asarray(y), jnp.asarray(buf_tok)))
    _, vjp = jax.vjp(lambda yy: combine(yy, jnp.asarray(buf_tok)), jnp.asarray(y))
    (want_grad,) = vjp(jnp.asarray(up))
    ty = _torch(y, tdt).requires_grad_(True)
    got = ops.ordered_scatter_rows(tg, torch.from_numpy(buf_tok), ty)  # the pad dropped
    assert np.array_equal(_bits(got.detach()), _bits(_torch(want, tdt)))
    (grad,) = torch.autograd.grad(got, ty, _torch(up, tdt))
    assert np.array_equal(_bits(grad), _bits(_torch(np.asarray(want_grad), tdt)))
