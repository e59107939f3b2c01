"""The port stands alone: no ``jax``, no ``repro``; entry points default
to the card and raise where there is none."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")


def _port_modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def _imported_roots(path):
    """Top-level package names a Python file imports (absolute imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = _port_modules()
    assert len(mods) >= 20, mods
    for m in ("repro_torch.configs.base", "repro_torch.models.transformer",
              "repro_torch.models.transformer_host",
              "repro_torch.runtime.serving", "repro_torch.kernels.merged_ffn",
              "repro_torch.kernels.merged_conv",
              "repro_torch.kernels.depthwise_conv",
              "repro_torch.kernels.cuda_build", "repro_torch.kernels.ops",
              "repro_torch.kernels.quant", "repro_torch.core.latency",
              "repro_torch.core.tables", "repro_torch.core.compress",
              "repro_torch.models.cnn_host", "repro_torch.compress",
              "repro_torch.models.rglru", "repro_torch.kernels.rmsnorm",
              "repro_torch.kernels.rglru_scan",
              "repro_torch.kernels.flash_attention",
              "repro_torch.configs.recurrentgemma_2b",
              "repro_torch.configs.resnet34",
              "repro_torch.configs.mobilenetv2",
              "repro_torch.configs.ddpm_cifar10",
              "repro_torch.testing.faults", "repro_torch.models.moe",
              "repro_torch.models.xlstm", "repro_torch.configs.gemma_7b",
              "repro_torch.configs.qwen2_7b",
              "repro_torch.configs.musicgen_large",
              "repro_torch.configs.command_r_plus_104b",
              "repro_torch.configs.granite_moe_1b_a400m",
              "repro_torch.configs.qwen3_moe_30b_a3b",
              "repro_torch.configs.qwen2_vl_7b",
              "repro_torch.configs.xlstm_125m", "repro_torch.tree",
              "repro_torch.optim.adamw", "repro_torch.optim.compress",
              "repro_torch.data.pipeline", "repro_torch.checkpoint.ckpt",
              "repro_torch.train.step", "repro_torch.train.loop",
              "repro_torch.launch.train", "repro_torch.core.dist_build",
              "repro_torch.launch.distributed", "repro_torch.testing.hosts",
              "repro_torch.testing.subproc", "repro_torch.launch.mesh",
              "repro_torch.sharding.rules",
              "repro_torch.sharding.collectives",
              "repro_torch.testing.world"):
        assert m in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in "
            "sys.modules if sys.modules[k] is not None)\n"
            "print('OK', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def _sources():
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(PORT)
             for f in fs if f.endswith(".py")]
    return files + [os.path.join(ROOT, "chip_smoke.py")]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_neither_jax_nor_repro(path):
    roots = _imported_roots(path)
    assert "jax" not in roots and "jaxlib" not in roots, path
    # 'repro' as a whole word: repro_torch is a different package
    assert "repro" not in roots, path


def test_scan_tells_repro_from_repro_torch(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.core\nfrom repro_torch import x\n")
    assert _imported_roots(str(p)) == {"repro_torch"}
    p.write_text("from repro.core import plan\n")
    assert "repro" in _imported_roots(str(p))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")


def test_default_device_raises_without_a_card(tmp_path):
    _no_card()
    from repro_torch import runtime
    from repro_torch.compress import main
    from repro_torch.models import cnn, cnn_host, zoo

    net = zoo.tiny_mobilenet(num_classes=4, in_hw=16, width=8)
    params = cnn.init_params(net)
    with pytest.raises(RuntimeError, match="cuda"):
        cnn_host.CNNHost(net, params)
    host = cnn_host.CNNHost(net, params, device="cpu")
    from repro_torch.core.plan import identity_plan
    graph = host.lower_plan(identity_plan(net.L, host.descs()))
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.execute(graph, torch.zeros(1, 16, 16, 3))
    path = str(tmp_path / "a.npz")
    runtime.save(path, graph)
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.load(path)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", "tiny_mobilenet", "--out", str(tmp_path / "b.npz")])
    assert not os.path.exists(tmp_path / "b.npz")
    # the training path: batches, the compressed forward, the launcher
    from repro_torch.data.pipeline import GlobalBatcher, SyntheticTokens
    from repro_torch.launch.train import main as train_main
    from repro_torch.train.step import make_compressed_forward
    with pytest.raises(RuntimeError, match="cuda"):
        GlobalBatcher(SyntheticTokens(16, 2, 4))
    with pytest.raises(RuntimeError, match="cuda"):
        make_compressed_forward(graph)(None, torch.zeros(1, 16, 16, 3))
    with pytest.raises(RuntimeError, match="cuda"):
        train_main(["--arch", "smollm-135m", "--reduced", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "ck")])
    assert not os.path.exists(tmp_path / "ck")


def test_distributed_entry_points_default_to_the_card():
    _no_card()
    import inspect

    from repro_torch.core.dist_build import dist_build_tables
    from repro_torch.launch import distributed as dist
    from repro_torch.testing import hosts
    params = inspect.signature(dist_build_tables).parameters
    assert params["worker_device"].default == "cuda"
    assert inspect.signature(dist.worker_env).parameters[
        "device"].default == "cuda"
    for factory in (hosts.tiny_resnet_host, hosts.conv_chain_host):
        with pytest.raises(RuntimeError, match="cuda"):
            factory()
    with pytest.raises(RuntimeError, match="cuda"):
        hosts.cli_host(arch="tiny_resnet")
    for smoke in (dist.dist_smoke, dist.dist_fault_smoke,
                  dist.serve_failover_smoke):
        with pytest.raises(RuntimeError, match="cuda"):
            smoke()


def test_serving_entry_points_take_rules():
    """Every serving entry point, ``runtime.load`` and the executor take
    ``rules=``, as the JAX package's do (the sharded serving path,
    ``tests/test_torch_mesh.py``); the default is None: no mesh."""
    import inspect

    from repro_torch import runtime
    from repro_torch.runtime import serving
    for fn in (serving.serve_loop, serving.serve_loop_pertoken,
               serving.serve_requests, serving.ContinuousEngine,
               serving.serve_continuous, serving.serve_with_failover,
               runtime.load, runtime.GraphExecutor,
               runtime.CompressedArtifact.executor):
        param = inspect.signature(fn).parameters.get("rules")
        assert param is not None and param.default is None, fn


def test_wallclock_oracle_refuses_the_cpu():
    _no_card()
    from repro_torch.core.latency import WallClockOracle
    with pytest.raises(RuntimeError, match="cuda"):
        WallClockOracle().time_callable(lambda: None)


def test_cuda_kernels_build_lazily():
    """Importing the kernel modules neither builds nor needs nvcc."""
    from repro_torch.kernels import cuda_build
    merged = ("depthwise_conv", "merged_conv", "merged_ffn")
    assert cuda_build.SOURCES == ("depthwise_conv", "flash_attention",
                                  "flash_attention_bf16", "merged_conv",
                                  "merged_ffn", "rglru_scan", "rmsnorm")
    assert set(cuda_build.SIGNATURES) == set(cuda_build.SOURCES) | {
        f"{s}_q" for s in merged} | {"merged_ffn_slots", "rmsnorm_bf16",
                                     "rglru_scan_bwd"}
    for name in cuda_build.SOURCES:
        src = cuda_build.CSRC / f"{name}.cu"
        assert src.exists()
        text = src.read_text()
        for entry, (source, c_name, _) in cuda_build.SIGNATURES.items():
            if source == name:
                assert f"extern \"C\" int {c_name}(" in text, entry
        assert cuda_build.library_path(name).name.startswith(f"lib{name}-")


def test_build_dir_is_the_checkout_or_the_user_cache(tmp_path, monkeypatch):
    """A source checkout builds into its own ``build/``; an installed
    package into the user's cache, never beside site-packages."""
    from repro_torch.kernels import cuda_build
    assert cuda_build.BUILD_DIR == Path(ROOT) / "build" / "repro_torch"
    site = tmp_path / "lib" / "site-packages"
    fake = site / "repro_torch" / "kernels" / "cuda_build.py"
    monkeypatch.setattr(cuda_build, "__file__", str(fake))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert cuda_build._build_dir() == tmp_path / "cache" / "repro_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert cuda_build._build_dir() == (tmp_path / "home" / ".cache"
                                       / "repro_torch")
