"""The Mamba-1 (falcon-mamba-7b) and Zamba-2 (zamba2-7b) forwards split
over "model" (``models/mamba.py``, ``models/hybrid.py`` under a mesh,
``common.leaf_sharding``), on the CPU against the JAX reference
(``tests/torch_split.py``):

* the legacy ``ServeEngine(mesh=)`` greedy f32 streams of each smoke
  config on (1, 2) and (1, 4) gloo ranks, dense and at static capacities
  0.25 / 0.75 (kernel 5's plain version on the CPU), equal the
  reference's single-device ``ServeEngine.generate``: tokens exact,
  logprobs within 1e-5, on every rank;
* the FSDP step on (2, 2), without and with Megatron-SP residuals, equals
  ``jax.value_and_grad`` of the reference's ``lm_loss``: loss within 1e-5
  relative, every rank's gradient blocks within 1e-5 · max |g|;
* the packed-leaf slicing: every SSM leaf cut to each rank's block by the
  family's blocks and put back together (``rules.Sharding.full``) is the leaf,
  at M = 2 and 4, serve and train modes, and each block holds the rank's
  units or heads;
* a model axis that does not divide the SSM heads raises
  NotImplementedError naming the arch and the axis;
* each arch's decode_32k cell on (16, 16) holds the layout's shard sizes.

Both rank groups start at import of the module fixture and run while the
reference computes its side."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.sharding import rules

import torch_ranks as tr
import torch_split as ts

torch.set_num_threads(1)

ARCHS = ("falcon-mamba-7b", "zamba2-7b")
WORLDS = (2, 4)
# (arch, sp_residuals, remat) of the FSDP cases
GRAD_CASES = (("falcon-mamba-7b", False, "minimal"),
              ("falcon-mamba-7b", True, "none"),
              ("zamba2-7b", False, "minimal"),
              ("zamba2-7b", True, "save_ars"))


@pytest.fixture(scope="module")
def runs():
    legacy = ts.legacy_cases(ARCHS)
    grads = []
    for arch, sp, remat in GRAD_CASES:
        jcfg = ts.ref_config(arch, sp_residuals=sp)
        jp = ts.ref_params(jcfg, seed=3)
        grads.append((jcfg.to_json(), ts._np(jp), ts.grad_batch(jcfg), remat))
    cases = [c for _, c, _ in legacy]
    gets = {2: tr.group(tr.split_family_checks, 2, (cases, None)),
            4: tr.group(tr.split_family_checks, 4, (cases, grads))}
    want = {cid: make() for cid, _, make in legacy}
    ref = {}
    for arch, _, _ in GRAD_CASES:
        if arch not in ref:
            jcfg = ts.ref_config(arch)
            ref[arch] = ts.reference_grads(jcfg, ts.ref_params(jcfg, seed=3),
                                           ts.grad_batch(jcfg))
    return gets, [cid for cid, _, _ in legacy], want, ref


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ts.MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_streams_on_a_model_axis_equal_reference(runs, arch, mode,
                                                        world):
    gets, ids, want, _ = runs
    i = ids.index(f"{arch}-{mode}")
    for rank in gets[world]():
        ts.hold_streams(rank["legacy"][i], want[ids[i]])


@pytest.mark.parametrize("i", range(len(GRAD_CASES)),
                         ids=[f"{a}-{'sp' if s else 'nosp'}-{r}"
                              for a, s, r in GRAD_CASES])
def test_fsdp_step_equals_value_and_grad(runs, i):
    gets, _, _, ref = runs
    arch = GRAD_CASES[i][0]
    for rank in gets[4]():
        loss, blocks = rank["grads"][i]
        ts.hold_grads(loss, blocks, *ref[arch], what=str(GRAD_CASES[i]))


def _mesh(data, model, rank):
    return Mesh(shape={"data": data, "model": model},
                coords={"data": rank // model, "model": rank % model})


def _ssm_leaves(cfg):
    params = registry.get_family(cfg).init_params(cfg, seed=0, device="cpu",
                                                  dtype=torch.float32)
    return {f"layers/ssm/{k}": v for k, v in params["layers"]["ssm"].items()}


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_packed_leaves_shard_and_gather_back(arch, M, mode):
    cfg = smoke_config(arch)
    D = 1 if mode == "serve" else 2
    di, st, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    for path, leaf in _ssm_leaves(cfg).items():
        shs = [cm.leaf_sharding(cfg, path, leaf.shape, _mesh(D, M, r), mode)
               for r in range(D * M)]
        got = torch.stack([s.block(leaf) for s in shs])
        np.testing.assert_array_equal(shs[0].full(got).numpy(),
                                      leaf.numpy(), err_msg=path)
        name = path.rsplit("/", 1)[1]
        for r, s in enumerate(shs):
            lay = cm._layout(cfg, M, r % M, mode)
            u0, ul = lay.inner
            blk = got[r]
            if D > 1 and "data" in s.spec:
                continue  # the data rows' cut is the rules' own
            if name == "in_proj":
                if cfg.family == "mamba":
                    want = torch.cat([leaf[..., u0:u0 + ul],
                                      leaf[..., di + u0:di + u0 + ul]], -1)
                else:
                    h0, hl = lay.ssm_heads
                    want = torch.cat([leaf[..., u0:u0 + ul],
                                      leaf[..., di + u0:di + u0 + ul],
                                      leaf[..., 2 * di:2 * di + 2 * st],
                                      leaf[..., 2 * di + 2 * st + h0:
                                           2 * di + 2 * st + h0 + hl]], -1)
            elif name in ("x_proj", "A_log") and cfg.family == "mamba":
                want = leaf[:, u0:u0 + ul]
            elif name == "out_proj":
                want = leaf[:, u0:u0 + ul]
            elif cfg.family == "hybrid" and name in ("A_log", "D",
                                                     "dt_bias"):
                h0, hl = lay.ssm_heads
                want = leaf[..., h0:h0 + hl]
            else:
                want = leaf[..., u0:u0 + ul]
            np.testing.assert_array_equal(blk.numpy(), want.numpy(),
                                          err_msg=f"{path} rank {r}")
    assert nh % M == 0 and di % M == 0


def test_a_model_axis_that_does_not_divide_the_heads_raises():
    cfg = smoke_config("zamba2-7b")  # 8 SSM heads
    params = registry.get_family(cfg).init_params(cfg, seed=0, device="meta")
    with pytest.raises(NotImplementedError,
                       match=f"{cfg.name} at TP=16: 8 SSM heads .*'model'"):
        cm.shard_params(cfg, params, _mesh(1, 16, 0), "serve")


def _want_bytes(cfg, shape):
    """The bytes rank 0 of (16, 16) holds in a decode cell, from the
    layout by hand: the serve rules' blocks of the non-SSM leaves, the
    rank's units or heads of the SSM leaves, the batch over "data" and
    the caches' units, heads or positions over "model"."""
    mesh = Mesh(shape={"data": 16, "model": 16},
                coords={"data": 0, "model": 0})
    row = mesh.model_row()
    di, st, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    nh = cfg.n_ssm_heads
    total = 0
    whole = specs.params_spec(cfg)
    for path, leaf in _paths(whole):
        shp = list(leaf.shape)
        name = path.rsplit("/", 1)[-1]
        if "/ssm/" in path:
            if name == "in_proj":
                shp[-1] = (2 * di // 16 if cfg.family == "mamba" else
                           2 * di // 16 + 2 * st + nh // 16)
            elif name in ("x_proj", "out_proj") or (
                    name == "A_log" and cfg.family == "mamba"):
                shp[-2] //= 16
            else:
                shp[-1] //= 16
        else:
            spec = rules.param_pspec(path, tuple(shp), row, "serve")
            shp = [n // (16 if a else 1) for n, a in zip(shp, spec)]
        total += ts.block_bytes(shp)
    b = shape.global_batch // 16
    L = cfg.n_layers
    if cfg.family == "mamba":
        cache = [(L, b, di // 16, st), (L, b, k - 1, di // 16)]
    else:
        from repro_torch.models import hybrid
        na, hd = hybrid.n_attn_applications(cfg), cfg.resolved_head_dim
        kvp = cm.HeadGeometry(cfg.n_heads, cfg.n_kv_heads, hd).kvp
        cache = [(L, b, nh // 16, st, cfg.ssm_head_dim),
                 (L, b, k - 1, di // 16)] + [(na, b, kvp,
                                              shape.seq_len // 16, hd)] * 2
    total += sum(ts.block_bytes(c) for c in cache)
    return total + 2 * 512  # the rank's tokens and positions


def _paths(tree, prefix=""):
    for key, v in tree.items():
        p = f"{prefix}/{key}" if prefix else key
        if isinstance(v, dict):
            yield from _paths(v, p)
        else:
            yield p, v


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cell_holds_the_layout_shard_sizes(arch):
    from repro_torch.configs import SHAPES
    rec = dryrun.run_cell(arch, "decode_32k")
    assert "error" not in rec and rec["fits"]
    assert rec["arg_bytes"] == _want_bytes(get_config(arch),
                                           SHAPES["decode_32k"])
    assert rec["collectives_by_axis"]["model"]["count"] > 0
    assert rec["collectives_by_axis"]["data"]["count"] == 0
