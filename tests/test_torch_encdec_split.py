"""The Whisper (whisper-small) forward split over "model"
(``models/encdec.py`` under a mesh: the encoder and the decoder's
self-attention and FFN through the transformer's split code, the
cross-attention on the rank's heads), on the CPU against the JAX
reference (``tests/torch_split.py``):

* the legacy ``ServeEngine(mesh=)`` greedy f32 streams of the smoke
  config (4 heads padded to 16 slots, seeded frames) on (1, 2) and (1, 4)
  gloo ranks, dense and at static capacities 0.25 / 0.75, equal the
  reference's single-device ``ServeEngine.generate``: tokens exact,
  logprobs within 1e-5, on every rank;
* the FSDP step on (2, 2), its encoder and decoder stacks gathered layer
  by layer, equals ``jax.value_and_grad`` of the reference's ``lm_loss``:
  loss within 1e-5 relative, every rank's gradient blocks within 1e-5 ·
  max |g|;
* the decode_32k cell on (16, 16) holds the layout's shard sizes: the
  self-attention cache by sequence, the cross K/V by the rank's kv heads,
  12 heads padded to 16 slots one a rank."""
import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import common as cm
from repro_torch.sharding import rules

import torch_ranks as tr
import torch_split as ts

torch.set_num_threads(1)

ARCH = "whisper-small"
WORLDS = (2, 4)
REMATS = ("minimal", "save_ars")


@pytest.fixture(scope="module")
def runs():
    legacy = ts.legacy_cases((ARCH,))
    jcfg = ts.ref_config(ARCH)
    jp = ts.ref_params(jcfg, seed=3)
    batch = ts.grad_batch(jcfg)
    grads = [(jcfg.to_json(), ts._np(jp), batch, r) for r in REMATS]
    cases = [c for _, c, _ in legacy]
    gets = {2: tr.group(tr.split_family_checks, 2, (cases, None)),
            4: tr.group(tr.split_family_checks, 4, (cases, grads))}
    want = {cid: make() for cid, _, make in legacy}
    return gets, [cid for cid, _, _ in legacy], want, ts.reference_grads(
        jcfg, jp, batch)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ts.MODES)
def test_legacy_streams_on_a_model_axis_equal_reference(runs, mode, world):
    gets, ids, want, _ = runs
    i = ids.index(f"{ARCH}-{mode}")
    for rank in gets[world]():
        ts.hold_streams(rank["legacy"][i], want[ids[i]])


@pytest.mark.parametrize("i", range(len(REMATS)), ids=REMATS)
def test_fsdp_step_equals_value_and_grad(runs, i):
    gets, _, _, ref = runs
    for rank in gets[4]():
        loss, blocks = rank["grads"][i]
        ts.hold_grads(loss, blocks, *ref, what=REMATS[i])


def _paths(tree, prefix=""):
    for key, v in tree.items():
        p = f"{prefix}/{key}" if prefix else key
        if isinstance(v, dict):
            yield from _paths(v, p)
        else:
            yield p, v


def test_decode_cell_holds_the_layout_shard_sizes():
    cfg = get_config(ARCH)
    shape = SHAPES["decode_32k"]
    rec = dryrun.run_cell(ARCH, "decode_32k")
    assert "error" not in rec and rec["fits"]
    row = Mesh(shape={"data": 1, "model": 16},
               coords={"data": 0, "model": 0})
    want = 0
    for path, leaf in _paths(specs.params_spec(cfg)):
        spec = rules.param_pspec(path, tuple(leaf.shape), row, "serve")
        want += ts.block_bytes([n // (16 if a else 1)
                                for n, a in zip(leaf.shape, spec)])
    g = cm.HeadGeometry(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert g.kvp == 16  # 12 heads padded to 16 slots: one a rank
    b, L, hd = shape.global_batch // 16, cfg.n_layers, g.head_dim
    want += 2 * ts.block_bytes((L, b, g.kvp, shape.seq_len // 16, hd))
    want += 2 * ts.block_bytes((L, b, 1, cfg.n_audio_frames, hd))
    want += 2 * 512  # the rank's tokens and positions
    assert rec["arg_bytes"] == want
    assert rec["collectives_by_axis"]["model"]["count"] > 0
