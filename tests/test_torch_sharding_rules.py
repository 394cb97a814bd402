"""The port's sharding rules against the reference's, in process (no ranks):
``param_pspec`` for every leaf of every registered config's parameter tree
in both modes, and the buffer specs, on (1, 2), (1, 4), (1, 8), (2, 4) and
(2, 16) meshes — a stand-in mesh with ``shape`` and ``axis_names`` serves
both packages; ``shard_params`` blocks put back together give the tree;
``pack_tile_indices(n_groups)`` equals the reference's packing and keeps
its two properties; ``make_host_mesh`` warns or raises on an unsatisfiable
shape; the engine and the CLI reject meshes they do not serve; and each
rank's ``ShardLayout`` of the full-width configs."""
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.models import registry as jreg
from repro.predictor import predictors as jpred
from repro.sharding import rules as jrules
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.predictor import predictors as tpred
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
from repro_torch.sharding import comm, rules

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(1, 2), (1, 4), (1, 8), (2, 4), (2, 16)]


class AxisMesh:
    """A mesh both packages' spec functions read: axis sizes and names."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")


def _leaves(arch):
    """('/'-joined path, shape) of every leaf of the reference's parameter
    tree of ``arch``, from jax.eval_shape (nothing allocated)."""
    cfg = jget_config(arch)
    fam = jreg.get_family(cfg)
    tree = jax.eval_shape(lambda k: fam.init_params(k, cfg),
                          jax.random.PRNGKey(0))
    return [(jrules._path_str(p), tuple(leaf.shape)) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", jlist_archs())
def test_param_pspec_matches_reference(arch):
    leaves = _leaves(arch)
    assert leaves
    for data, model in MESHES:
        mesh = AxisMesh(data, model)
        for mode in ("serve", "train"):
            for path, shape in leaves:
                want = tuple(jrules.param_pspec(path, shape, mesh, mode))
                got = rules.param_pspec(path, shape, mesh, mode)
                assert got == want, (arch, (data, model), mode, path, shape)


def test_port_trees_have_the_reference_leaves():
    """The port's trees (tiny configs, built on the CPU) hold the
    reference's paths at the reference's shapes, so the spec lists above
    are the port's too."""
    for arch in ("tiny-relu", "tiny-opt", "tiny-moe"):
        cfg = get_config(arch)
        tree = registry.get_family(cfg).init_params(cfg, seed=0, device="cpu")
        got = sorted((p, tuple(t.shape)) for p, t in _flat(tree))
        assert got == sorted(_leaves(arch)), arch


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


_BUFFER_CASES = {
    "batch_pspec": [(b, e) for b in (1, 2, 3, 8, 16, 32, 64) for e in (0, 1, 2)],
    "cache_pspec": [((2, b, kvp, S, 64),) for b in (1, 2, 8, 32)
                    for kvp in (2, 16) for S in (7, 64, 2048)],
    "paged_cache_pspec": [((2, nb, kvp, 16, 128),) for nb in (13, 14, 64, 129)
                          for kvp in (1, 2, 4, 8, 16, 32)],
    "serve_masks_pspec": [(shape,) for shape in
                          ((2, 2, 256), (2, 4, 16384), (32, 8, 6400),
                           (3, 256), (8, 16384), (2, 16, 100))],
    "ssm_cache_pspec": [(shape,) for shape in
                        ((2, 4, 8192, 16), (2, 4, 4, 8192), (2, 3, 512, 16),
                         (64, 32, 1024, 1024))],
    "logits_pspec": [(b, s) for b in (1, 2, 4, 8, 32) for s in (False, True)],
}


@pytest.mark.parametrize("fn", sorted(_BUFFER_CASES))
def test_buffer_specs_match_reference(fn):
    for data, model in MESHES:
        mesh = AxisMesh(data, model)
        for args in _BUFFER_CASES[fn]:
            want = tuple(getattr(jrules, fn)(*args[:1], mesh, *args[1:]))
            got = getattr(rules, fn)(*args[:1], mesh, *args[1:])
            assert got == want, (fn, args, (data, model))


def test_tp_size_and_dp():
    assert rules.tp_size(None) == 1
    for data, model in MESHES:
        mesh = AxisMesh(data, model)
        assert rules.tp_size(mesh) == jrules.tp_size(mesh) == model
        assert rules.dp_size(mesh) == jrules.dp_size(mesh) == data


def _rank_mesh(data, model, d, m):
    return Mesh(shape={"data": data, "model": model},
                coords={"data": d, "model": m}, device=torch.device("cpu"))


@pytest.mark.parametrize("arch,shape", [("tiny-relu", (1, 4)),
                                        ("tiny-opt", (1, 8)),
                                        ("tiny-moe", (2, 4))])
def test_shard_params_blocks_reassemble(arch, shape):
    """Every rank's blocks, put back at their offsets, give each leaf; every
    element is held by the same number of ranks (those that share its
    block), and a block of a split dim is 1/axis of it."""
    cfg = get_config(arch).replace(compute_dtype="float32")
    tree = registry.get_family(cfg).init_params(cfg, seed=0, device="cpu")
    data, model = shape
    full = dict(_flat(tree))
    back = {p: torch.zeros_like(t) for p, t in full.items()}
    hits = {p: torch.zeros_like(t, dtype=torch.int32) for p, t in full.items()}
    for d in range(data):
        for m in range(model):
            mesh = _rank_mesh(data, model, d, m)
            for path, block in _flat(cm.shard_params(cfg, tree, mesh)):
                spec = rules.param_pspec(path, tuple(full[path].shape), mesh,
                                         "serve")
                assert block.is_contiguous()
                sl = []
                for dim, axis in enumerate(spec):
                    if axis is None:
                        sl.append(slice(None))
                        continue
                    i, n = rules.axis_block(mesh, axis)
                    size = full[path].shape[dim] // n
                    assert block.shape[dim] == size
                    sl.append(slice(i * size, (i + 1) * size))
                back[path][tuple(sl)] = block
                hits[path][tuple(sl)] += 1
    mesh0 = _rank_mesh(data, model, 0, 0)
    for path, t in full.items():
        spec = rules.param_pspec(path, tuple(t.shape), mesh0, "serve")
        n_blocks = int(np.prod([rules.axis_block(mesh0, a)[1]
                                for a in spec if a is not None]))
        copies = data * model // n_blocks  # ranks holding the same block
        assert torch.equal(hits[path], torch.full_like(hits[path], copies))
        assert torch.equal(back[path], t), path


def test_shard_layouts_at_full_width():
    """Each rank's share of the full-width configs the card serves: OPT-6.7B
    at TP = 2 holds 16 of its 32 heads and half of d_ff 16384; Mixtral-8x22B
    4 of 8 experts, 24 q slots and 4 of 8 kv heads; tiny-relu at TP = 4 its
    two kv heads split over d_model (GQA), each rank's 4 q slots reading one
    head."""
    def lay(arch, tp, rank):
        mesh = _rank_mesh(1, tp, 0, rank)
        with comm.serving(mesh):
            return cm.shard_layout(get_config(arch))

    opt = lay("opt-6.7b", 2, 1)
    assert (opt.q, opt.kv, opt.kv_split, opt.ffn) == ((16, 16), (16, 16),
                                                      "heads", (8192, 8192))
    assert opt.heads.group == 1 and opt.ffn_split and opt.vocab_split
    mix = lay("mixtral-8x22b", 2, 1)
    assert (mix.q, mix.kv, mix.kv_split, mix.experts, mix.ffn) == (
        (24, 24), (4, 4), "heads", (4, 4), (0, 16384))
    assert mix.heads.group == 6 and not mix.ffn_split
    for rank in range(4):
        t = lay("tiny-relu", 4, rank)
        assert t.kv_split == "embed" and t.d == (16 * rank, 16)
        assert t.q == (4 * rank, 4) and t.kv == (rank // 2, 1)
        assert t.heads.group == 4 and t.ffn == (64 * rank, 64)
    assert lay("tiny-relu", 2, 1).kv_split == "heads"
    assert cm.shard_layout(get_config("tiny-relu")) is None  # no mesh
    with comm.serving(_rank_mesh(1, 1, 0, 0)):
        assert cm.shard_layout(get_config("tiny-relu")) is None  # TP = 1


def test_predictor_pspec():
    mesh = AxisMesh(1, 4)
    assert rules.predictor_pspec("w", (2, 64, 256), mesh) == (None, None,
                                                              "model")
    assert rules.predictor_pspec("b", (2, 8, 256), mesh) == (None, None,
                                                             "model")
    assert rules.predictor_pspec("a", (2, 64, 8), mesh) == (None,) * 3
    assert rules.predictor_pspec("tau", (2,), mesh) == (None,)
    assert rules.predictor_pspec("w", (2, 64, 6), mesh) == (None,) * 3


# ---------------------------------------------------------------------------
# model-axis-local tile packing


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 6), st.integers(0, 2 ** 20 - 1), st.integers(1, 20))
def test_grouped_packing_matches_global_at_full_capacity(g_pow, bits, seed):
    """At full capacity (k == n_tiles) the grouped packing selects the same
    tiles in the same ascending order as the global packing."""
    n_groups = 2 ** (g_pow % 4)  # 1, 2, 4, 8
    nT = 16
    rng = np.random.RandomState(seed)
    mask = torch.as_tensor((rng.rand(3, nT) < 0.4)
                           | (np.arange(nT) == bits % nT))
    idx0, nv0 = tpred.pack_tile_indices(mask, nT)
    idx1, nv1 = tpred.pack_tile_indices(mask, nT, n_groups=n_groups)
    assert torch.equal(nv0, nv1)
    for t in range(mask.shape[0]):
        n = int(nv0[t])
        assert torch.equal(idx0[t, :n], idx1[t, :n])


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 16), st.integers(1, 4), st.integers(0, 10 ** 6))
def test_grouped_packing_truncation_in_range_and_balanced(k, g_pow, seed):
    """Under truncation every index stays in range, valid entries come
    first, ascending, and each group's selection is drawn from its own
    slice within its own capacity."""
    n_groups = 2 ** (g_pow % 3)  # 1, 2, 4
    nT = 16
    rng = np.random.RandomState(seed)
    mask = rng.rand(4, nT) < 0.7
    idx, nv = tpred.pack_tile_indices(torch.as_tensor(mask), k,
                                      n_groups=n_groups)
    idx, nv = idx.numpy(), nv.numpy()
    assert ((idx >= 0) & (idx < nT)).all()
    k_g = min(nT // n_groups, -(-min(k, nT) // n_groups))
    assert (nv <= n_groups * k_g).all()
    gsz = nT // n_groups
    for t in range(mask.shape[0]):
        sel = idx[t, :nv[t]]
        assert (np.diff(sel) > 0).all(), "valid entries not ascending"
        assert mask[t, sel].all()
        for g in range(n_groups):
            assert ((sel // gsz) == g).sum() <= k_g


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 24), st.sampled_from([1, 2, 4, 8]),
       st.integers(0, 10 ** 6), st.sampled_from([0.1, 0.5, 0.9]))
def test_grouped_packing_equals_reference(k, n_groups, seed, p):
    """The port's packing is the reference's, index for index, on the same
    masks, at every capacity (pads included)."""
    nT = 16
    mask = np.random.RandomState(seed).rand(5, nT) < p
    j_idx, j_nv = jpred.pack_tile_indices(jnp.asarray(mask), k,
                                          n_groups=n_groups)
    t_idx, t_nv = tpred.pack_tile_indices(torch.as_tensor(mask), k,
                                          n_groups=n_groups)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_nv.numpy(), np.asarray(j_nv))


def test_rank_slice_packing_is_its_group():
    """A rank of the sharded engine packs its own d_ff slice as one group
    of ceil(k / TP): the reference's group of that rank, in local ids."""
    rng = np.random.RandomState(3)
    nT, tp = 32, 4
    mask = torch.as_tensor(rng.rand(6, nT) < 0.5)
    for k in (3, 8, 20, 32):
        g_idx, g_nv = tpred.pack_tile_indices(mask, k, n_groups=tp)
        k_g = min(nT // tp, -(-k // tp))
        for r in range(tp):
            sl = mask[:, r * nT // tp:(r + 1) * nT // tp]
            l_idx, l_nv = tpred.pack_tile_indices(sl, k_g)
            for t in range(mask.shape[0]):
                mine = [int(i) - r * nT // tp for i in g_idx[t, :g_nv[t]]
                        if r * nT // tp <= i < (r + 1) * nT // tp]
                assert l_idx[t, :l_nv[t]].tolist() == mine


@pytest.mark.parametrize("F,tile,groups,tp,most", [
    (256, 16, 1, 2, 0), (256, 16, 1, 4, 0), (96, 32, 1, 4, 0),
    (256, 32, 2, 4, 0), (256, 16, 4, 4, 0), (256, 64, 2, 2, 16)])
def test_rank_tiles_split_the_static_product(F, tile, groups, tp, most):
    """The ranks' parts of one static-capacity tile list (``rank_tiles``)
    cover it exactly: each part lists its valid units first and no more
    than its slice holds, and the ranks' f32 products summed equal the
    one-device gathered product (tiles straddling a slice boundary, or
    wider than ``most``, split at the finer tile)."""
    rng = np.random.RandomState(F + tile + groups + tp)
    x = rng.randn(3, F) * (rng.rand(1, F // tile, 1) < 0.6).repeat(
        tile, 2).reshape(1, F)
    w = torch.as_tensor(rng.randn(F, 24))
    x = torch.as_tensor(x)
    idx, mask = cm.select_active_tiles(cm.tile_scores(x, tile), 0.5, groups)
    want = cm.gathered_matmul(x, w, idx, mask, tile)
    got = torch.zeros_like(want)
    fl = F // tp
    for r in range(tp):
        il, ml, s = cm.rank_tiles(idx, mask, tile, r * fl, fl, most)
        assert len(il) <= fl // s and (not most or s <= most)
        nv = int(ml.sum())
        assert (ml[:nv] == 1).all() and (ml[nv:] == 0).all()
        got += cm.gathered_matmul(x[:, r * fl:(r + 1) * fl],
                                  w[r * fl:(r + 1) * fl], il, ml, s,
                                  out_dtype=torch.float64)
    # both sum in f32, in another order
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# meshes the port does not take


def test_make_host_mesh_degenerate_warns_and_strict_raises():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mesh = make_host_mesh(1, 2, device="cpu")  # one rank: clamp + warn
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.coords == {"data": 0, "model": 0} and mesh.group is None
    assert any("degenerating" in str(x.message) for x in w)
    with pytest.raises(ValueError, match="degenerating"):
        make_host_mesh(1, 2, strict=True, device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        make_host_mesh(1, 1, device="cpu")
    assert not w


def test_engine_rejects_meshes_it_does_not_serve():
    cfg = get_config("tiny-relu").replace(compute_dtype="float32")
    params = registry.get_family(cfg).init_params(cfg, seed=0, device="cpu")
    rows = Mesh(shape={"rows": 1}, coords={"rows": 0},
                device=torch.device("cpu"), axis_names=("rows",))
    with pytest.raises(ValueError, match="data.*model|model.*data"):
        ContinuousBatchingEngine(cfg, params, EngineConfig(mesh=rows),
                                 device="cpu")
    # a data axis above 1 is served: the rank holds half the pool's blocks
    eng = ContinuousBatchingEngine(cfg, params, EngineConfig(
        mesh=_rank_mesh(2, 2, 1, 0), n_blocks=14), device="cpu")
    assert eng.data.blocks == (7, 7) and eng.pages["k"].shape[1] == 7


def test_cli_mesh_raises_when_the_world_cannot_hold_it():
    """Under a launcher's world of one rank, --mesh 1,2 and --mesh 2,2
    raise (strict); a mesh that is not two ints exits."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE="1", RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(port),
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "tiny-relu", "--smoke", "--continuous", "--device", "cpu"]
    for mesh in ("1,2", "2,2"):
        r = subprocess.run(cmd + ["--mesh", mesh], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and "degenerating" in r.stderr, \
            r.stderr[-2000:]
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "tiny-relu", "--smoke", "--mesh", "4",
                    "--device", "cpu"])
