"""Shared inputs of the ``test_torch_*`` parity tests: networks of the zoo
at CI size and their parameters made with numpy from a seed, in the JAX
package's parameter structure, handed to both packages."""
import jax
import numpy as np

from repro.models import cnn as jcnn

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
