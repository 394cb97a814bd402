"""The port's last four kernel modules against the JAX reference's Pallas
kernels (interpret mode on the CPU): ``fused_up_relu_tokens``,
``fused_up_relu_window``, ``expert_up_matmul`` and ``expert_down_matmul``,
with ``expert_tile_lists``. On the CPU every wrapper takes its plain
PyTorch version; the CUDA kernels are held against those plain versions on
the card (the ``cuda``-marked test here, and chip_smoke.py).

Tolerance 1e-5 (f32): the two sum in different orders. Tile lists must
match exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_ffn as jff
from repro.kernels import sparse_matmul as jsm
from repro_torch.kernels import fused_ffn as tff
from repro_torch.kernels import sparse_matmul as tsm
from test_torch_kernels import bf16_terms, walk_tile_groups

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()), np.asarray(want),
                               **TOL)


def _both(a, jdtype=jnp.float32, tdtype=torch.float32):
    """One numpy array handed to both frameworks."""
    a = np.asarray(a)
    return jnp.asarray(a, jdtype), torch.as_tensor(a).to(tdtype)


# ---------------------------------------------------------------------------
# fused_up_relu_tokens / fused_up_relu_window


@pytest.mark.parametrize("T,d,F,shift", [(4, 128, 512, 0.0),
                                         (5, 64, 384, 0.5), (1, 64, 256, 0.0)])
def test_fused_up_relu_tokens_matches_reference(T, d, F, shift):
    rng = np.random.RandomState(T + d)
    jx, tx = _both(rng.randn(T, d))
    jw, tw = _both(rng.randn(d, F) / np.sqrt(d))
    h_want, s_want = jff.fused_up_relu_tokens(jx, jw, shift, block_f=128)
    h, s = tff.fused_up_relu_tokens(tx, tw, shift)
    assert h.shape == (T, F) and s.shape == (T, F // 128)
    _close(h, h_want)
    _close(s, s_want)
    # the per-token scores fold to the all-rows kernel's
    _close(s.amax(0), tff.fused_up_relu(tx, tw, shift)[1])


@pytest.mark.parametrize("B,W,shift", [(3, 4, 0.0), (2, 5, 0.5), (4, 1, 0.0)])
def test_fused_up_relu_window_matches_reference(B, W, shift):
    rng = np.random.RandomState(5 + W)
    d, F = 128, 512
    jx, tx = _both(rng.randn(B, W, d))
    jw, tw = _both(rng.randn(d, F) / np.sqrt(d))
    h_want, s_want = jff.fused_up_relu_window(jx, jw, shift, block_f=256)
    h, s = tff.fused_up_relu_window(tx, tw, shift)
    assert h.shape == (B, W, F) and s.shape == (B, F // 128)
    _close(h, h_want)
    _close(s, s_want)
    _, s_tok = tff.fused_up_relu_tokens(tx.reshape(B * W, d), tw, shift)
    _close(s, s_tok.reshape(B, W, -1).amax(1))
    if W == 1:  # a one-token window is the per-token score
        assert torch.equal(s, s_tok)


# ---------------------------------------------------------------------------
# expert_tile_lists: exact


@pytest.mark.parametrize("E,k,tpe,padded", [(4, 2, 3, False), (8, 2, 4, True),
                                            (5, 3, 2, True), (2, 1, 1, False)])
def test_expert_tile_lists_match_reference_exactly(E, k, tpe, padded):
    """Every token's lists and counts equal the reference's, including the
    padding rule: entries past k_valid * tpe repeat the FIRST tile."""
    rng = np.random.RandomState(E * 10 + k)
    topi = np.stack([rng.permutation(E)[:k] for _ in range(7)]).astype(np.int32)
    kv = rng.randint(0, k + 1, 7).astype(np.int32) if padded else None
    j_idx, j_nv = jsm.expert_tile_lists(
        jnp.asarray(topi), tpe, None if kv is None else jnp.asarray(kv))
    t_idx, t_nv = tsm.expert_tile_lists(
        torch.as_tensor(topi), tpe, None if kv is None else torch.as_tensor(kv))
    assert t_idx.dtype == torch.int32 and t_nv.dtype == torch.int32
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_nv.numpy(), np.asarray(j_nv))


# ---------------------------------------------------------------------------
# expert_up_matmul / expert_down_matmul


def _expert_case(seed=0, T=6, k=2, E=4, d=16, F=64, tile=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, d).astype(np.float32)
    wu = (rng.randn(E, d, F) * 0.1).astype(np.float32)
    wd = (rng.randn(E, F, d) * 0.1).astype(np.float32)
    topi = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    kv = np.array([2, 2, 1, 0, 2, 1][:T], np.int32)
    idx, nv = jsm.expert_tile_lists(jnp.asarray(topi), F // tile, jnp.asarray(kv))
    return x, wu, wd, topi, kv, np.array(idx), np.array(nv), tile


@pytest.mark.parametrize("padded", [False, True])
def test_expert_up_matmul_matches_reference(padded):
    x, wu, _, topi, kv, idx, nv, tile = _expert_case(seed=1)
    if not padded:
        idx, nv = (np.array(a) for a in
                   jsm.expert_tile_lists(jnp.asarray(topi), wu.shape[2] // tile))
    want = jsm.expert_up_matmul(jnp.asarray(x), jnp.asarray(wu),
                                jnp.asarray(idx), jnp.asarray(nv), tile=tile,
                                interpret=True)
    got = tsm.expert_up_matmul(torch.as_tensor(x), torch.as_tensor(wu),
                               torch.as_tensor(idx), torch.as_tensor(nv),
                               tile=tile)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)
    live = np.arange(idx.shape[1])[None, :] < nv[:, None]
    assert not got.numpy()[~live].any()  # exact zeros past nvalid


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_expert_down_matmul_matches_reference(w_dtype):
    """f32 blocks against f32 weights, and against bf16 weights: the
    reference's mixed dot promotes the weights and keeps the blocks as
    they are."""
    _, _, wd, _, _, idx, nv, tile = _expert_case(seed=2)
    rng = np.random.RandomState(3)
    compact = rng.randn(idx.shape[0], idx.shape[1], tile).astype(np.float32)
    jw, tw = _both(wd, getattr(jnp, w_dtype), getattr(torch, w_dtype))
    want = jsm.expert_down_matmul(jnp.asarray(compact), jw, jnp.asarray(idx),
                                  jnp.asarray(nv), block_d=wd.shape[2],
                                  interpret=True)
    got = tsm.expert_down_matmul(torch.as_tensor(compact), tw,
                                 torch.as_tensor(idx), torch.as_tensor(nv))
    assert got.dtype == torch.float32
    _close(got, want)
    assert not got.numpy()[nv == 0].any()


def test_expert_down_matmul_keeps_f32_compact_unrounded():
    """f32 blocks of 1 + 2^-10 against bf16 weights of 3: rounded to bf16
    the blocks would read 1.0 and the sums 3 * n; unrounded they read
    (1 + 2^-10) * 3 * n, as the reference computes (n >= 16 here, so the
    two differ by 3 * n / 1024 >= 0.046)."""
    T, K, tile, E, F, d = 2, 4, 8, 2, 16, 4
    compact = np.full((T, K, tile), 1.0 + 2.0 ** -10, np.float32)
    w = np.full((E, F, d), 3.0, np.float32)
    idx = np.array([[0, 1, 2, 3], [3, 2, 0, 0]], np.int32)
    nv = np.array([4, 2], np.int32)
    got = tsm.expert_down_matmul(torch.as_tensor(compact),
                                 torch.as_tensor(w).bfloat16(),
                                 torch.as_tensor(idx), torch.as_tensor(nv))
    want = (1.0 + 2.0 ** -10) * 3.0 * tile * nv[:, None] * np.ones((T, d))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    rounded = 3.0 * tile * nv[:, None] * np.ones((T, d))
    assert np.abs(got.numpy() - rounded).min() > 0.04
    ref = jsm.expert_down_matmul(jnp.asarray(compact),
                                 jnp.asarray(w, jnp.bfloat16), jnp.asarray(idx),
                                 jnp.asarray(nv), block_d=d, interpret=True)
    _close(got, ref)


def test_expert_chain_matches_per_expert_dense_product():
    """expert_up_matmul -> relu -> expert_down_matmul equals the per-expert
    dense products over each token's live experts (the reference test's
    check), capacity-dropped assignments included."""
    x, wu, wd, topi, kv, idx, nv, tile = _expert_case(seed=0)
    t = [torch.as_tensor(a) for a in (x, wu, wd, idx, nv)]
    compact = tsm.expert_up_matmul(t[0], t[1], t[3], t[4], tile=tile)
    y = tsm.expert_down_matmul(torch.relu(compact), t[2], t[3], t[4])
    ref = np.zeros_like(y.numpy())
    for i in range(x.shape[0]):
        for j in range(int(kv[i])):
            e = int(topi[i, j])
            ref[i] += np.maximum(x[i] @ wu[e], 0.0) @ wd[e]
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert not compact.numpy()[3].any()  # the token with no live expert


# ---------------------------------------------------------------------------
# expert_down_matmul's tile-grouped routine: plan and plain walk


@pytest.mark.parametrize("T", [8, 128])
def test_plan_chunks_hold_one_experts_tokens_at_mixtral_routing(T):
    """Mixtral-8x22B's routing shape (E = 8, top-2, tpe = 128): with runs
    of tpe tile ids each chunk holds tokens routed to one expert, and the
    chunks of expert e hold exactly its tokens, each once."""
    E, k, tpe = 8, 2, 128
    rng = np.random.RandomState(T)
    topi = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    idx, nv = tsm.expert_tile_lists(torch.as_tensor(topi), tpe)
    plan = tsm.tile_group_plan(idx, nv, tpe, E)
    cpr = -(-T // tsm.TG_M)
    for e in range(E):
        rows = plan.chunk_rows[e * cpr:(e + 1) * cpr].reshape(-1).tolist()
        assert [t for t in rows if t >= 0] == [t for t in range(T) if e in topi[t]]
    assert all(bin(int(m) & 0xff).count("1") == k for m in plan.mask)


_DOWN_CASES = {  # topi-free lists over E = 4 experts x tpe = 4 tiles
    "k_valid drops": None,
    "repeated tiles": ([[5, 5, 0, 1, 2, 3, 3, 3], [12, 13, 14, 15, 4, 5, 6, 7],
                        [9, 9, 9, 9, 9, 9, 9, 9]], [8, 6, 3]),
    "unsorted, nvalid 0": ([[7, 2, 13, 0, 11, 4, 4, 4], [1, 1, 1, 1, 1, 1, 1, 1],
                            [15, 8, 3, 6, 0, 10, 5, 12]], [6, 0, 8]),
}


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_DOWN_CASES))
def test_expert_down_walk_matches_plain_and_reference(case, w_dtype):
    """The plain walk of the routine in compact mode (one run per expert,
    chunks, unions, zeroed rows, repeated tiles summed slot by slot, the
    ascending-expert sum) equals expert_down_matmul's plain version and the
    Pallas kernel; f32 blocks against bf16 weights through three bf16
    terms stay within 1e-5 of the unrounded product."""
    E, F, d, tile = 4, 64, 16, 16
    rng = np.random.RandomState(11)
    if _DOWN_CASES[case] is None:
        _, _, _, _, _, idx, nv, _ = _expert_case(seed=6)
    else:
        idx, nv = (np.asarray(a, np.int32) for a in _DOWN_CASES[case])
    wd = (rng.randn(E, F, d) * 0.3).astype(np.float32)
    compact = rng.randn(idx.shape[0], idx.shape[1], tile).astype(np.float32)
    jw, tw = _both(wd, getattr(jnp, w_dtype), getattr(torch, w_dtype))
    tc, ti, tn = map(torch.as_tensor, (compact, idx, nv))
    got = walk_tile_groups(tc, tw, ti, tn, tile=tile, run=F // tile,
                           compact=True,
                           terms=3 if w_dtype == "bfloat16" else None, chunk=2)
    _close(got, tsm.expert_down_matmul_plain(tc, tw, ti, tn))
    _close(got, jsm.expert_down_matmul(jnp.asarray(compact), jw,
                                       jnp.asarray(idx), jnp.asarray(nv),
                                       block_d=d, interpret=True))
    assert not got.numpy()[nv == 0].any()


def test_bf16_three_terms_reproduce_f32_values():
    """hi + mid + lo of the routine's split equals each f32 value to within
    2^-24 of its magnitude (two terms are off by up to 2^-16), over values
    spread across 60 binades."""
    rng = np.random.RandomState(0)
    v = torch.as_tensor((rng.randn(100000) * 2.0 ** rng.randint(-30, 30, 100000))
                        .astype(np.float32))
    hi, mid, lo = bf16_terms(v, 3)
    for term in (hi, mid, lo):
        assert torch.equal(term, term.to(torch.bfloat16).float())
    err3 = ((hi.double() + mid.double() + lo.double()) - v.double()).abs()
    assert (err3 <= 2.0 ** -24 * v.double().abs()).all()
    err2 = ((hi.double() + mid.double()) - v.double()).abs()
    assert (err2 > 2.0 ** -24 * v.double().abs()).any()


def test_wrappers_take_plain_versions_on_cpu():
    """CPU tensors never count a launch: the wrappers run the plain
    versions."""
    fns = (tff.fused_up_relu_tokens, tff.fused_up_relu_window,
           tsm.expert_up_matmul, tsm.expert_down_matmul)
    before = [f.launches for f in fns]
    x, wu, wd, _, _, idx, nv, tile = _expert_case(seed=4)
    t = [torch.as_tensor(a) for a in (x, wu, wd, idx, nv)]
    w2 = torch.randn(16, 256)
    tff.fused_up_relu_tokens(t[0], w2)
    tff.fused_up_relu_window(t[0].reshape(2, 3, 16), w2)
    compact = tsm.expert_up_matmul(t[0], t[1], t[3], t[4], tile=tile)
    tsm.expert_down_matmul(compact, t[2], t[3], t[4])
    assert [f.launches for f in fns] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the CUDA kernels have no "
                    "CPU mode; their plain versions are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_expert_and_score_kernels_match_plain_versions(cuda_device):
    """On the card: the four kernels against their plain versions at small
    f32 shapes, each launch counted."""
    c = lambda a: torch.as_tensor(a).to(cuda_device)  # noqa: E731
    rng = np.random.RandomState(0)
    x, w = c(rng.randn(6, 64).astype(np.float32)), c(rng.randn(64, 384).astype(np.float32))
    for fn, plain, xs in ((tff.fused_up_relu_tokens,
                           tff.fused_up_relu_tokens_plain, x),
                          (tff.fused_up_relu_window,
                           tff.fused_up_relu_window_plain, x.reshape(2, 3, 64))):
        n0 = fn.launches
        for a, b in zip(fn(xs, w, 0.25), plain(xs, w, 0.25)):
            torch.testing.assert_close(a, b, **TOL)
        assert fn.launches == n0 + 1
    x, wu, wd, _, _, idx, nv, tile = _expert_case(seed=5)
    x, wu, wd, idx, nv = (c(a) for a in (x, wu, wd, idx, nv))
    compact = tsm.expert_up_matmul(x, wu, idx, nv, tile=tile)
    torch.testing.assert_close(
        compact, tsm.expert_up_matmul_plain(x, wu, idx, nv, tile=tile), **TOL)
    for w in (wd, wd.bfloat16()):
        torch.testing.assert_close(
            tsm.expert_down_matmul(compact, w, idx, nv),
            tsm.expert_down_matmul_plain(compact, w, idx, nv), **TOL)
