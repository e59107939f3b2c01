"""Shared inputs of the ``test_torch_*`` parity tests: networks of the zoo
and transformer configs at CI size, and their parameters made with numpy
from a seed, in the JAX package's parameter structure, handed to both
packages."""
import dataclasses

import jax
import numpy as np

from repro.configs import get_config as j_get_config
from repro.models import cnn as jcnn
from repro.models import transformer as jtr

ZOO = {
    "tiny_resnet": dict(num_classes=4, in_hw=16, width=8, blocks=(2, 2)),
    "tiny_mobilenet": dict(num_classes=4, in_hw=16, width=8),
    "tiny_unet": dict(in_hw=16, base=8),
}


def np_params(net, seed=0):
    """The structure of ``repro.models.cnn.init_params(net)`` filled from
    ``np.random.default_rng(seed)``: He-scaled weights and non-trivial
    BN/GN statistics (variances positive)."""
    shapes = jax.eval_shape(lambda: jcnn.init_params(net,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name == "var":
            return (rng.random(leaf.shape) + 0.5).astype(np.float32)
        if name in ("gamma",):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)
                    ).astype(np.float32)
        if len(leaf.shape) >= 2:
            fan = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) * np.sqrt(1.0 / fan)
                    ).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def lm_configs():
    """``(name, JAX config, port config)`` at CI size, fp32: the reduced
    smollm (d 32, 2 layers), a 4-layer d 96 variant and a local-attention
    variant with a 4-token ring buffer."""
    from repro_torch.configs import get_config as t_get_config

    jbase = j_get_config("smollm-135m").reduced()
    tbase = t_get_config("smollm-135m").reduced()
    variants = {
        "reduced": {},
        "d96": dict(num_layers=4, d_model=96, num_heads=3, num_kv_heads=1,
                    head_dim=32, d_ff=160, vocab_size=80),
        "local": dict(temporal_pattern=("attn", "attn_local"),
                      local_window=4),
    }
    return {name: (dataclasses.replace(jbase, **kw),
                   dataclasses.replace(tbase, **kw))
            for name, kw in variants.items()}


def rg_configs():
    """``(JAX config, port config)`` of RecurrentGemma-2B reduced to CI size
    (3 layers: rglru, rglru, attn_local; d 32, rnn_width 32, window 8)."""
    from repro_torch.configs import get_config as t_get_config

    return (j_get_config("recurrentgemma-2b").reduced(),
            t_get_config("recurrentgemma-2b").reduced())


#: C_DECAY of the RG-LRU block (``a = exp(-C · softplus(Λ) · r)``).
_C_DECAY = 8.0


def np_lm_params(cfg, seed=0):
    """The structure of ``repro.models.transformer.init_model(cfg)`` filled
    from ``np.random.default_rng(seed)``: 1/sqrt(fan-in) weights and
    non-zero norm scales, so the ``(1 + g)`` fold is exercised.  RG-LRU
    leaves: Λ drawn as ``init_rglru`` draws it (``-log a`` at r = 1 is C
    times ``-log`` of a uniform draw in (0.9^C, 0.999^C)), conv taps and
    bias at 0.1.  xLSTM forget-gate biases ``bf`` near ``init_mlstm``'s
    3 (3 ± 0.5), its input-gate biases ``bi`` at 0.1; an MoE ``w_down``
    at 1/sqrt(moe_dff)."""
    shapes = jax.eval_shape(
        lambda: jtr.init_model(cfg, jax.random.PRNGKey(0))[0])
    rng = np.random.default_rng(seed)
    dr = cfg.rnn_width or cfg.d_model
    fan = {"w_down": cfg.d_ff or cfg.moe_dff,
           "wo": cfg.num_heads * cfg.head_dim,
           "w_out": dr, "w_a": dr, "w_x": dr}

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if "norm" in name:
            return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "bf":
            return (3.0 + 0.5 * rng.standard_normal(leaf.shape)
                    ).astype(np.float32)
        if name == "bi":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "lam":
            u = rng.uniform(0.9 ** _C_DECAY, 0.999 ** _C_DECAY, leaf.shape)
            return np.log(np.expm1(-np.log(u))).astype(np.float32)
        if name in ("conv_w", "conv_b"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        scale = 1.0 / np.sqrt(fan.get(name, cfg.d_model))
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)
