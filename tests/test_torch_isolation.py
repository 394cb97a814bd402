"""The PyTorch port stands alone: nothing under src/repro_torch/, and not
chip_smoke.py, imports jax or the JAX package ``repro``; the port serves
with both made unimportable, through the engine and through the launcher's
engine behind ``AsyncServingEngine``; and its entry points never fall back
to the CPU when CUDA is absent."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"{path} imports {bad}"


def test_port_serves_with_jax_and_reference_unimportable():
    prog = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
        cfg = get_config("tiny-opt").replace(compute_dtype="float32")
        params = T.init_params(cfg, seed=0, device="cpu")
        eng = ContinuousBatchingEngine(
            cfg, params, EngineConfig(n_slots=2, prefill_chunk=4),
            device="cpu")
        uids = [eng.submit(np.arange(1, n + 1), 4, reuse_window=2)
                for n in (5, 9)]
        res = eng.run()
        assert all(len(res[u].tokens) == 4 for u in uids)
        # the front door: the launcher's engine behind the async API
        import asyncio
        from repro_torch.launch.serve_api import build_engine, parse_args
        from repro_torch.serving import AsyncServingEngine
        eng = build_engine(parse_args(["--arch", "tiny-relu", "--f32",
                                       "--device", "cpu"]))

        async def serve():
            async with AsyncServingEngine(eng) as api:
                return await api.generate([3, 1, 4, 1, 5], 4)

        ev = asyncio.run(asyncio.wait_for(serve(), 120))
        assert ev.finish_reason == "length" and len(ev.result.tokens) == 4
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]


def test_predictor_mode_and_ops_run_with_jax_and_reference_unimportable(
        tmp_path):
    """Calibration, the checkpoint format, predictor-mode serving and
    sparse_ffn_apply need nothing of JAX or the JAX package."""
    prog = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import torch
        from repro_torch.configs import get_config
        from repro_torch.kernels.ops import sparse_ffn_apply
        from repro_torch.models import transformer as T
        from repro_torch.predictor import calibrate, load_predictor, save_predictor
        from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
        cfg = get_config("tiny-relu").replace(compute_dtype="float32")
        params = T.init_params(cfg, seed=0, device="cpu")
        toks = torch.as_tensor(np.arange(48).reshape(2, 24) % cfg.vocab_size)
        pred = calibrate(params, cfg, {{"tokens": toks}}, kind="lowrank",
                         rank=4, target_recall=0.9, tile=1)
        save_predictor(pred, {str(tmp_path)!r})
        pred = load_predictor({str(tmp_path)!r}, device="cpu")
        eng = ContinuousBatchingEngine(
            cfg, params, EngineConfig(n_slots=2, predictor=pred), device="cpu")
        uids = [eng.submit(np.arange(1, n + 1), 4) for n in (5, 9)]
        res = eng.run()
        assert all(len(res[u].tokens) == 4 for u in uids)
        assert 0.0 < eng.predictor_density() <= 1.0
        y, h, idx, nvalid = sparse_ffn_apply(
            torch.randn(3, 64), torch.randn(64, 256), torch.randn(256, 64),
            device="cpu")
        assert y.shape == (3, 64) and idx.shape == (1,)
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]


def test_moe_serving_and_expert_gathers_run_with_jax_and_reference_unimportable():
    """MoE serving (chunked, γ-window reuse), the grouped-gather MoE FFN
    and the per-token / window score kernels' entry points need nothing of
    JAX or the JAX package."""
    prog = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import torch
        from repro_torch.configs import get_config
        from repro_torch.kernels import fused_ffn
        from repro_torch.models import moe
        from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
        cfg = get_config("tiny-moe").replace(compute_dtype="float32")
        params = moe.init_params(cfg, seed=0, device="cpu")
        eng = ContinuousBatchingEngine(
            cfg, params, EngineConfig(n_slots=2, prefill_chunk=4),
            device="cpu")
        uids = [eng.submit(np.arange(1, n + 1), 4, reuse_window=2)
                for n in (5, 9)]
        res = eng.run()
        assert all(len(res[u].tokens) == 4 for u in uids)
        assert eng.expert_io_fraction() == 0.5
        pm = {k: v[0] for k, v in params["layers"]["moe"].items()}
        x = torch.randn(6, cfg.d_model)
        y = moe.apply_moe_gathered(pm, x, cfg)
        assert torch.allclose(y, moe.apply_moe(pm, x, cfg), atol=1e-5)
        h, s = fused_ffn.fused_up_relu_window(torch.randn(2, 3, 64),
                                              torch.randn(64, 256))
        assert h.shape == (2, 3, 256) and s.shape == (2, 2)
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]


def test_sampled_and_spec_serving_run_with_jax_and_reference_unimportable():
    """The seeded sampling head, its key schedule and speculative serving
    (dense target with a 1-layer draft, chunked prefill) need nothing of
    JAX or the JAX package."""
    prog = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.serving import (ContinuousBatchingEngine,
                                         EngineConfig, SamplingParams,
                                         spec_metrics)
        cfg = get_config("tiny-relu").replace(compute_dtype="float32")
        dcfg = cfg.replace(name="tiny-relu-draft", n_layers=1)
        params = T.init_params(cfg, seed=0, device="cpu")
        dparams = T.init_params(dcfg, seed=2, device="cpu")
        eng = ContinuousBatchingEngine(
            cfg, params, EngineConfig(n_slots=2, prefill_chunk=4,
                                      draft_cfg=dcfg, draft_params=dparams,
                                      gamma=3), device="cpu")
        sp = SamplingParams(temperature=0.9, top_p=0.9, seed=2 ** 32 + 5)
        uids = [eng.submit(np.arange(1, n + 1), 6, sampling=sp)
                for n in (5, 9)]
        res = eng.run()
        assert all(len(res[u].tokens) == 6 for u in uids)
        m = spec_metrics(res[uids[0]], gamma=3, c=0.1,
                         s_agg=eng.s_agg_window())
        assert m.n_draft_calls > 0 and 0.0 <= eng.s_agg_window() < 1.0
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]


def test_moe_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        moe.init_params(get_config("tiny-moe"))


def test_entry_points_raise_without_cuda(monkeypatch):
    """No device given means CUDA; with none available the engine and the
    model raise instead of running on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousBatchingEngine

    cfg = get_config("tiny-opt").replace(compute_dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(cfg)


def test_plain_path_never_runs_on_cuda(monkeypatch):
    """On the card the serving steps take the kernels: asking the engine or
    a model step for the plain path there raises. On the CPU the plain path
    is the default and the kernel path's structure is opt-in."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    card = SimpleNamespace(is_cuda=True)  # kernel_path reads only is_cuda
    with pytest.raises(ValueError, match="fast_kernels=False on CUDA"):
        T.kernel_path(False, card)
    assert T.kernel_path(None, card) and T.kernel_path(True, card)
    cpu = torch.zeros(1)
    assert not T.kernel_path(None, cpu) and not T.kernel_path(False, cpu)
    assert T.kernel_path(True, cpu)

    cfg = get_config("tiny-opt").replace(compute_dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="fast_kernels=False on CUDA"):
        ContinuousBatchingEngine(cfg, params, EngineConfig(fast_kernels=False))


def test_engine_rejects_params_on_another_device():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousBatchingEngine

    cfg = get_config("tiny-opt").replace(compute_dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="params must lie on cpu"):
        ContinuousBatchingEngine(cfg, params, device="cpu")
