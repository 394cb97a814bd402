"""The plan's sparse decode cells counted by kernel 5's own bytes
(``kernels/sparse_matmul.py::sparse_matmul`` on "meta" tensors is the
operator ``repro_torch::sparse_matmul``, which ``launch/op_cost.OpCost``
counts by its bound's formula), and the
dry run's layer fit over Zamba-2's shared block, on the CPU.

* kernel 5 on meta tensors returns an empty (T, D) f32 output, launches
  nothing, and is charged nvalid x tile x D weight bytes, x's selected
  columns, the list and y, and 2·T·nvalid·tile·D FLOPs, with every listed
  slot valid;
* every arch's sparse decode_32k cell on (16, 16) counts fewer HBM bytes
  than its dense cell, kernel 5 charged once a gathered product;
* the dry-run table shows a sparse cell's density and nothing beside it;
* a hybrid cell fitted from 1, 2 and ``attn_every`` layers counts what a
  full run counts."""
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import sparse_matmul as ksm
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.op_cost import OpCost


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel5_on_meta_charges_its_own_formula(dtype):
    T, F, D, K, tile = 4, 512, 96, 3, 64
    meta = torch.device("meta")
    x = torch.empty((T, F), dtype=dtype, device=meta)
    w = torch.empty((F, D), dtype=dtype, device=meta)
    idx = torch.empty((K,), dtype=torch.int32, device=meta)
    nvalid = torch.empty((), dtype=torch.int32, device=meta)
    before = ksm.sparse_matmul.launches
    with OpCost() as cost:
        y = ksm.sparse_matmul(x, w, idx, nvalid, tile=tile)
    assert ksm.sparse_matmul.launches == before
    assert y.shape == (T, D) and y.dtype == torch.float32 and y.is_meta
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = (K * tile * D * size + T * K * tile * size + K * 4 + 4
              + T * D * 4)
    flops = 2.0 * T * K * tile * D
    assert cost.kernels["sparse_matmul"] == [1, nbytes, flops]
    assert cost.bytes == nbytes and cost.flops == flops
    assert cost.peak >= T * D * 4  # the output is held


SPARSE_ARCHS = ("qwen3-4b", "falcon-mamba-7b", "zamba2-7b",
                "whisper-small")


@pytest.mark.parametrize("arch", SPARSE_ARCHS)
def test_sparse_decode_cell_counts_fewer_bytes_than_dense(arch):
    dense = dryrun.run_cell(arch, "decode_32k")
    sparse = dryrun.run_cell(arch, "decode_32k", sparse=0.6)
    assert "error" not in dense and "error" not in sparse
    assert sparse["bytes_per_chip"] < dense["bytes_per_chip"]
    assert sparse["t_memory"] < dense["t_memory"]
    k5 = sparse["kernels"]["sparse_matmul"]
    assert k5["launches"] > 0 and 0 < k5["bytes"] < sparse["bytes_per_chip"]
    assert dense["kernels"] == {}


def test_table_shows_the_sparse_density_alone():
    rec = dict(arch="qwen3-4b", shape="decode_32k", mesh="16x16",
               t_compute=1e-5, t_memory=5e-3, t_collective=2e-3,
               bottleneck="memory", useful_flops_ratio=1.0,
               peak_bytes_per_chip=3e9)
    lines = roofline.table([rec, dict(rec, sparse=0.6)]).splitlines()
    assert len(lines) == 3
    assert lines[1].split()[2] == "-"
    assert lines[2].split()[2] == "0.6"


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_hybrid_fit_equals_a_full_run(shape):
    cfg = smoke_config("zamba2-7b").replace(attn_every=3, n_layers=7)
    kw = dict(mesh_shape=(2, 2), batch=8, seq=32, cfg=cfg,
              microbatches=4 if shape == "train_4k" else 0)
    full = dryrun.run_cell("zamba2-7b", shape, extrapolate=False, **kw)
    fit = dryrun.run_cell("zamba2-7b", shape, extrapolate=True, **kw)
    assert fit["extrapolated_from"]["layers"] == [1, 2, 3]
    for k in ("flops_per_chip", "wire_bytes_per_chip", "collectives",
              "collective_counts", "collectives_by_axis", "arg_bytes"):
        assert fit[k] == full[k], k
    assert fit["bytes_per_chip"] == pytest.approx(full["bytes_per_chip"],
                                                  rel=1e-4)
    assert fit["peak_bytes_per_chip"] == pytest.approx(
        full["peak_bytes_per_chip"], rel=0.1)
