"""Package rules of the port: it imports neither JAX nor the JAX package,
its entry points run on the card unless asked for the CPU, and the CPU
calls of its kernel wrappers take the plain versions without counting a
launch."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (tests import both frameworks; the port never does)
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.kernels.decode_stats import ops as stats_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.transformer import init_params

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|repro)(?:\.|\s|$)",
                       re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_and_builds_nothing():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "from repro_torch.kernels import _build\n"
            "assert _build._lib is None and _build._info is None\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = " ".join(_modules())
    for mod in ("launch.serve", "core.topology", "core.schedules",
                "core.cost_model", "core.autotune", "core.comm_record",
                "core.collectives", "kernels.dma_allgather.schedule_compile",
                "kernels.dma_allgather.ref", "kernels.dma_allgather.ops",
                "kernels.ssd.ref", "kernels.ssd.ops", "models.ssm",
                "configs.mamba2_780m"):
        assert f"repro_torch.{mod}" in names, mod


def test_source_scan_finds_no_jax_import():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        hits = IMPORT_RE.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} imports {hits}"


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch):
    from repro_torch.serve import Engine, ServeSpec
    from repro_torch.launch import serve as launcher
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("llama3.2-3b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, ServeSpec(batch=1, cache_len=16))
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--smoke"])


def test_train_entry_points_without_device_raise_when_cuda_is_absent(
        monkeypatch):
    from repro_torch.launch import train as launcher
    from repro_torch.train import Trainer, TrainerConfig, make_train_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("llama3.2-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, None, TrainerConfig(steps=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--smoke"])


def test_backward_sources_note_what_they_are_the_backward_of():
    for name, tpu in [("rmsnorm_bwd", "_rmsnorm_kernel"),
                      ("flash_attention_bwd", "_flash_kernel")]:
        head = (_build.CSRC / f"{name}.cu").read_text()[:3000]
        assert "Replaces: no TPU kernel" in head and tpu in head
        assert "Bound on the H100" in head and "Design" in head


def test_cpu_calls_take_plain_versions_and_count_nothing():
    counts = (rms_ops.LAUNCHES, flash_ops.LAUNCHES, stats_ops.LAUNCHES,
              rms_ops.BWD_LAUNCHES, flash_ops.BWD_DQ_LAUNCHES,
              flash_ops.BWD_DKDV_LAUNCHES, flash_ops.BWD_WGMMA_LAUNCHES,
              ssd_ops.LAUNCHES, ssd_ops.BWD_LAUNCHES)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 64), dtype=np.float32))
    sc = torch.zeros(64)
    torch.testing.assert_close(rms_ops.rmsnorm(x, sc),
                               rms_ops.rmsnorm_ref(x, sc), atol=0, rtol=0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 32), dtype=np.float32))
    torch.testing.assert_close(flash_ops.flash_attention(q, q, q),
                               flash_ops.attention_ref(q, q, q), atol=0,
                               rtol=0)
    s = torch.from_numpy(rng.standard_normal((1, 2, 1, 8), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 8, 2, 32), dtype=np.float32))
    o, l = stats_ops.accumulate(s, s.amax(-1), v)
    ro, rl = stats_ops.decode_stats_accumulate_ref(s, s.amax(-1), v)
    assert torch.equal(o, ro) and torch.equal(l, rl)
    o, lse = flash_ops.flash_attention_lse(q, q, q)
    flash_ops.flash_attention_bwd(q, q, q, o, q, lse)
    rms_ops.rmsnorm_bwd(x, sc, x)
    rms_ops.rmsnorm_gated_bwd(x, x, sc, x)
    xs = torch.from_numpy(rng.standard_normal((1, 8, 2, 16), dtype=np.float32))
    bc = torch.from_numpy(rng.standard_normal((1, 8, 1, 4), dtype=np.float32))
    dt, A = torch.full((1, 8, 2), 0.1), torch.full((2,), -1.0)
    y, _ = ssd_ops.ssd(xs, dt, A, bc, bc, Q=4)
    ssd_ops.ssd_bwd(xs, dt, A, bc, bc, y, Q=4)
    ssd_ops.ssd_train(xs.clone().requires_grad_(), dt, A, bc, bc,
                      Q=4)[0].sum().backward()
    assert (rms_ops.LAUNCHES, flash_ops.LAUNCHES, stats_ops.LAUNCHES,
            rms_ops.BWD_LAUNCHES, flash_ops.BWD_DQ_LAUNCHES,
            flash_ops.BWD_DKDV_LAUNCHES, flash_ops.BWD_WGMMA_LAUNCHES,
            ssd_ops.LAUNCHES, ssd_ops.BWD_LAUNCHES) == counts


def test_wrappers_refuse_mixed_devices_and_bad_dtypes():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(x, torch.zeros(8, device="meta"))
    with pytest.raises(TypeError):
        _build.dtype_code(torch.float16)


def test_build_is_keyed_by_sources_into_an_ignored_directory():
    names = {p.name for p in _build.CSRC.glob("*.cu")}
    assert {"rmsnorm.cu", "flash_attention.cu", "decode_stats.cu",
            "dma_allgather.cu", "ssd.cu"} <= names
    assert len(_build._key()) == 16
    assert _build.BUILD_ROOT.relative_to(REPO) == Path("build",
                                                       "repro_torch_kernels")
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_cuda_source_notes_name_the_tpu_kernel_they_replace():
    for name, tpu in [("rmsnorm", "_rmsnorm_kernel"),
                      ("flash_attention", "_flash_kernel"),
                      ("decode_stats", "_stats_kernel"),
                      ("dma_allgather", "_ag_kernel"),
                      ("ssd", "_ssd_kernel")]:
        head = (_build.CSRC / f"{name}.cu").read_text()[:2500]
        assert "Replaces:" in head and tpu in head
        assert "Bound on the H100" in head and "Design:" in head


def test_ssd_cpu_call_takes_the_plain_version_and_counts_nothing():
    from repro_torch.kernels.ssd import ops as ssd_ops
    before = ssd_ops.LAUNCHES
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 20, 2, 8), dtype=np.float32))
    dt = torch.full((1, 20, 2), 0.1)
    A = torch.tensor([-1.0, -2.0])
    B = torch.from_numpy(rng.standard_normal((1, 20, 1, 16), dtype=np.float32))
    y, h = ssd_ops.ssd(x, dt, A, B, B, Q=8)
    ry, rh = ssd_ops.ssd_ref(x, dt, A, B, B, Q=8)
    assert torch.equal(y, ry) and torch.equal(h, rh)
    assert ssd_ops.LAUNCHES == before


def test_mamba_engine_without_device_raises_when_cuda_is_absent(monkeypatch):
    from repro_torch.serve import Engine, ServeSpec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("mamba2-780m")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, ServeSpec(batch=1, cache_len=16))


def test_serve_launcher_serves_mamba_smoke_on_cpu(capsys):
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "9", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "mamba2-780m-smoke on cpu: drained 2 requests (6 tokens)" in out


@pytest.mark.parametrize("arch", sorted(configs.PENDING))
def test_serve_launcher_names_the_slice_a_pending_arch_waits_for(arch):
    from repro_torch.launch import serve as launcher
    with pytest.raises(NotImplementedError, match="waits for .*ROADMAP"):
        launcher.main(["--arch", arch, "--smoke", "--device", "cpu"])
