"""The port's config registry against the JAX package's.

* every id the port resolves gives the reference's config: the
  ``ConvNet`` of the zoo field by field for the paper's three CNNs (and
  MobileNetV2-1.4 beside them), the ``ArchConfig`` for the transformers;
* ``ShapeConfig``, ``SHAPES``, ``LONG_CONTEXT_OK``, ``ARCH_IDS`` and
  ``cells`` (with and without the skipped cells) are the reference's;
* the eight ids the port resolves since the other transformer families
  were ported give the reference's config, and the host refuses their
  published bf16 dtype; an unknown id raises ``KeyError``, and the CLI
  does not take a CNN config id;
* the config modules import neither ``jax`` nor ``repro``.
"""
import dataclasses
import importlib
import os
import subprocess
import sys

import pytest

from repro import configs as jconfigs
from repro_torch import configs as tconfigs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORTED = ("smollm-135m", "recurrentgemma-2b", "resnet34", "mobilenetv2",
          "ddpm-cifar10")
#: The ids the port resolved last (MoE, xLSTM, M-RoPE and the dense
#: transformers copied with them).
LATER = tuple(a for a in jconfigs.base._MODULES if a not in PORTED)
CNN_IDS = ("resnet34", "mobilenetv2", "ddpm-cifar10")
ALL_IDS = tuple(jconfigs.base._MODULES)


def _fields(cfg):
    """A config as plain data: dataclass fields, recursively (the specs of
    a ``ConvNet`` included), with the class names beside them."""
    if dataclasses.is_dataclass(cfg):
        return (type(cfg).__name__,
                {f.name: _fields(getattr(cfg, f.name))
                 for f in dataclasses.fields(cfg)})
    if isinstance(cfg, (tuple, list)):
        return tuple(_fields(v) for v in cfg)
    return cfg


@pytest.mark.parametrize("arch", PORTED)
def test_ported_config_equals_the_reference(arch):
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert _fields(t) == _fields(j)
    if arch not in CNN_IDS:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("arch", CNN_IDS)
def test_cnn_config_is_a_zoo_net_of_the_port(arch):
    from repro_torch.models import cnn, zoo
    cfg = tconfigs.get_config(arch)
    assert isinstance(cfg, cnn.ConvNet)
    build = {"resnet34": zoo.resnet34, "mobilenetv2": zoo.mobilenetv2,
             "ddpm-cifar10": zoo.ddpm_unet}[arch]
    assert cfg == build()


def test_mobilenetv2_14_equals_the_reference():
    t = importlib.import_module("repro_torch.configs.mobilenetv2")
    j = importlib.import_module("repro.configs.mobilenetv2")
    assert _fields(t.CONFIG_14) == _fields(j.CONFIG_14)
    assert t.CONFIG_14 != t.CONFIG
    assert t.CONFIG_14.spec(1).cout == 48           # 32 at width 1.4


def test_ddpm_unet_shape():
    """The reference's DDPM chain: 17 layers, a 4-channel input, two concat
    skips, one attention barrier, GN(8) on every conv but the output."""
    cfg = tconfigs.get_config("ddpm-cifar10")
    assert (cfg.L, cfg.in_ch, cfg.in_hw, cfg.head) == (17, 4, 32, "none")
    assert [sk.kind for sk in cfg.skips] == ["concat", "concat"]
    assert [s.kind for s in cfg.specs].count("attn") == 1
    convs = [s for s in cfg.specs if s.kind == "conv"]
    assert all(s.norm == "gn" and s.gn_groups == 8 for s in convs[:-1])
    assert (convs[-1].cout, convs[-1].norm) == (3, None)


def test_shapes_and_cells_equal_the_reference():
    assert _fields(tconfigs.ShapeConfig("a", 1, 2, "train")) == \
        _fields(jconfigs.ShapeConfig("a", 1, 2, "train"))
    assert {k: _fields(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: _fields(v) for k, v in jconfigs.SHAPES.items()}
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    assert tconfigs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for skipped in (False, True):
        assert tconfigs.cells(skipped) == jconfigs.cells(skipped)
    assert tconfigs.cells() == jconfigs.cells(include_skipped=False)
    assert len(tconfigs.cells(True)) == len(tconfigs.ARCH_IDS) * len(
        tconfigs.SHAPES)


def test_exports_are_the_reference_names():
    assert sorted(tconfigs.__all__) == sorted(jconfigs.__all__)


@pytest.mark.parametrize("arch", LATER)
def test_unported_id_raises(arch):
    """Each id that used to raise here resolves to the reference's config
    now; what still raises is its published dtype: the host runs fp32
    only (bf16 factors cannot be rank-merged, ROADMAP.md queue 3)."""
    from repro_torch.models.transformer_host import TransformerHost
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.dtype == "bfloat16"
    with pytest.raises(ValueError, match="fp32"):
        TransformerHost(t, {}, device="cpu")


def test_unknown_id_raises():
    with pytest.raises(KeyError, match="not ported"):
        tconfigs.get_config("no-such-net")


def test_cli_refuses_a_cnn_config_id():
    from repro_torch.compress import build_host
    with pytest.raises(ValueError, match="zoo names"):
        build_host("ddpm-cifar10", device="cpu")


def test_config_modules_import_neither_jax_nor_repro():
    mods = ["repro_torch.configs"] + [
        f"repro_torch.configs.{m}" for m in
        ("base", "resnet34", "mobilenetv2", "ddpm_cifar10", "smollm_135m",
         "recurrentgemma_2b", "gemma_7b", "qwen2_7b", "musicgen_large",
         "command_r_plus_104b", "granite_moe_1b_a400m", "qwen3_moe_30b_a3b",
         "qwen2_vl_7b", "xlstm_125m")]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from repro_torch.configs import get_config\n"
            f"for a in {ALL_IDS!r}:\n"
            "    get_config(a)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in "
            "sys.modules if sys.modules[k] is not None)\n"
            "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"
