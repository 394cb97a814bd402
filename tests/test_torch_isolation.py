"""The PyTorch port stands alone: nothing under src/repro_torch/, not the
port's examples (examples/*_torch.py) and not chip_smoke.py imports jax or
the JAX package ``repro``; the port serves
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
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples").glob("*_torch.py"))
              + [ROOT / "chip_smoke.py"])


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


def test_legacy_engine_runs_with_jax_and_reference_unimportable():
    """The legacy ServeEngine (γ-window reuse, tracking, static tile
    capacities, score) and the four assigned dense configs need nothing of
    JAX or the JAX package."""
    prog = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        from repro_torch.configs import get_config, smoke_config
        from repro_torch.core import relufication as rf
        from repro_torch.models import transformer as T
        from repro_torch.serving import ServeEngine
        cfg = get_config("tiny-relu").replace(compute_dtype="float32")
        params = T.init_params(cfg, seed=0, device="cpu")
        toks = np.arange(16).reshape(2, 8)
        for c in (cfg, rf.enable_sparse_serving(cfg, 0.5)):
            eng = ServeEngine(c, params, max_len=32, track_sparsity=True,
                              device="cpu")
            res = eng.generate({"tokens": toks}, max_new=5, reuse_window=2)
            assert res.tokens.shape == (2, 5) and res.site_sparsity
        assert np.isfinite(eng.score({"tokens": toks}))
        for name in ("qwen3-4b", "qwen2-7b", "starcoder2-15b", "deepseek-67b"):
            assert smoke_config(name).family == "dense"
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]


TRAINING_MODULES = ["configs/base.py", "tree.py", "optim/adamw.py",
                    "optim/schedules.py", "train/step.py", "train/loop.py",
                    "data/pipeline.py", "checkpoint/manager.py",
                    "launch/train.py", "core/sparsity.py",
                    "core/relufication.py", "core/flops.py"]


def test_scan_covers_the_training_modules():
    scanned = {str(p.relative_to(ROOT / "src" / "repro_torch"))
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert set(TRAINING_MODULES) <= scanned


def test_training_runs_with_jax_and_reference_unimportable(tmp_path):
    """The Trainer (async checkpoints, resume), the train step under every
    remat policy, the forward statistics, calibrate_shift, the FLOP
    accounting and the train CLI need nothing of JAX or the JAX package."""
    prog = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import torch
        from repro_torch.configs import SHAPES, TrainConfig, get_config
        from repro_torch.core import flops, relufication as rf
        from repro_torch.core.sparsity import measure_site_sparsity
        from repro_torch.data.pipeline import DataConfig, eval_batches
        from repro_torch.launch import train as train_cli
        from repro_torch.models import moe
        from repro_torch.optim import adamw
        from repro_torch.train.loop import Trainer
        from repro_torch.train.step import make_train_step
        cfg = rf.relufy_stage2(get_config("tiny").replace(
            compute_dtype="float32"))
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2)
        tc = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                         num_microbatches=2)
        quiet = dict(log=lambda *_: None, device="cpu")
        rep = Trainer(cfg, tc, dc, ckpt_dir={str(tmp_path)!r},
                      ckpt_every=2, **quiet).run(3)
        assert rep.steps == 3 and rep.skipped_steps == 0
        tr = Trainer(cfg, tc, dc, ckpt_dir={str(tmp_path)!r}, **quiet)
        assert tr.run(4).resumed_from == 3
        batch = {{k: torch.as_tensor(v)
                 for k, v in eval_batches(dc, 1)[0].items()}}
        sp = measure_site_sparsity(tr.params, batch, cfg)
        assert sp["mean/qkv"] > 0 and sp["mean/up"] > 0
        assert np.isfinite(rf.calibrate_shift(tr.params, batch, cfg, 0.9))
        mcfg = get_config("tiny-moe").replace(compute_dtype="float32")
        mp = moe.init_params(mcfg, device="cpu", dtype=torch.float32)
        for pol in ("none", "minimal", "full", "save_ars"):
            step = make_train_step(mcfg, TrainConfig(remat_policy=pol))
            _, _, m = step(mp, adamw.init_opt_state(mp), batch)
            assert float(m["step_ok"]) == 1.0
        assert flops.model_flops(get_config("llama-7b"),
                                 SHAPES["train_4k"]) > 0
        train_cli.main(["--arch", "tiny-relu", "--smoke", "--steps", "2",
                        "--device", "cpu"])
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]


FAMILY_MODULES = ["models/mamba.py", "models/hybrid.py", "models/encdec.py",
                  "models/vlm.py", "configs/other_families.py"]


def test_scan_covers_the_family_modules():
    scanned = {str(p.relative_to(ROOT / "src" / "repro_torch"))
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert set(FAMILY_MODULES) <= scanned


def test_other_families_serve_with_jax_and_reference_unimportable():
    """The legacy CLI serves falcon-mamba (smoke) and whisper (smoke,
    stub frames) with JAX and the JAX package made unimportable."""
    prog = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        from repro_torch.launch import serve
        for arch in ("falcon-mamba-7b", "whisper-small"):
            serve.main(["--arch", arch, "--smoke", "--tokens", "4",
                        "--device", "cpu"])
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    assert r.stdout.count("generated (2, 4) tokens") == 2, r.stdout


@pytest.mark.parametrize("family", ["mamba", "hybrid", "encdec", "vlm"])
def test_other_family_entry_points_raise_without_cuda(monkeypatch, family):
    """No device given means CUDA: each family's init and cache raise
    without it, and so does the legacy engine on CPU params."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import registry
    from repro_torch.serving import ServeEngine

    arch = {"mamba": "falcon-mamba-7b", "hybrid": "zamba2-7b",
            "encdec": "whisper-small", "vlm": "internvl2-1b"}[family]
    cfg = smoke_config(arch).replace(compute_dtype="float32")
    fam = registry.get_family(cfg)
    params = fam.init_params(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fam.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fam.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params)


def _load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_and_roofline_gate_run_with_jax_and_reference_unimportable():
    """The three port examples (cut step counts) and the serving roofline
    gate need nothing of JAX or the JAX package."""
    prog = textwrap.dedent("""
        import importlib.util, sys, warnings
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        torch.set_num_threads(1)
        warnings.simplefilter("ignore", DeprecationWarning)

        def example(name):
            spec = importlib.util.spec_from_file_location(
                name, f"examples/{name}_torch.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.main

        example("quickstart")(["--device", "cpu"])
        example("serve_sparse")(["--device", "cpu", "--train-steps", "2",
                                 "--draft-steps", "1"])
        example("train_relufication")(["--device", "cpu", "--steps", "2",
                                       "--finetune-steps", "1"])
        from repro_torch.launch import roofline
        assert roofline.main(["--serving", "--check", "--device", "cpu"]) == 0
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ALL OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0 and "ALL OK" in r.stdout, r.stderr[-3000:]
    for name in ("quickstart", "serve_sparse", "train_relufication"):
        assert f"{name} OK" in r.stdout


def test_examples_and_roofline_gate_raise_without_cuda(monkeypatch):
    """With no device given the examples and the gate run on the card;
    with none available they raise instead of running on the CPU."""
    from repro_torch.launch import roofline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("quickstart", []),
                       ("serve_sparse", ["--train-steps", "1"]),
                       ("train_relufication", ["--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _load_example(name).main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        roofline.main(["--serving", "--check"])
