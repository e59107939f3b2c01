"""Deterministic host factories that any process can resolve by name.

The distributed table build (:mod:`repro_torch.core.dist_build`) rebuilds
the host inside each worker process from a JSON host spec —
``{"factory": "module:function", "kwargs": {...}}`` — because a host
holds live tensors and cannot be sent over a pipe.  Every factory here is
seed-deterministic: parameters are drawn from a CPU
``torch.Generator`` and then moved to ``device``, so the same kwargs give
a host with the same ``fingerprint()`` in any process on the same
machine.  The fingerprint holds the machine token (the card's name), so
a worker on another device than its coordinator is drift, and drift
fails loudly.

Factories return ``(host, params)`` and take ``device=`` (the card by
default; 'cpu' runs the plain PyTorch versions).
"""
from __future__ import annotations


def tiny_resnet_host(*, num_classes: int = 4, in_hw: int = 8,
                     width: int = 4, blocks=(2,), batch: int = 4,
                     max_span=None, seed: int = 0, device="cuda",
                     **host_kw):
    """The fault smokes' CNN (the network the kill-and-resume smoke of
    :mod:`repro_torch.testing.faults` builds).  ``host_kw`` reaches
    :class:`~repro_torch.models.cnn_host.CNNHost` (e.g. the JAX
    package's cost model: ``dtype_bytes=2, tile_budget=...``)."""
    import torch

    from repro_torch.device import resolve
    from repro_torch.models import cnn, cnn_host, zoo

    device = resolve(device)
    net = zoo.tiny_resnet(num_classes=num_classes, in_hw=in_hw,
                          width=width, blocks=tuple(blocks))
    params = cnn.init_params(net, torch.Generator().manual_seed(seed),
                             device=device)
    return cnn_host.CNNHost(net, params, batch=batch, max_span=max_span,
                            device=device, **host_kw), params


def conv_chain_host(*, L: int = 5, max_span: int = 3, width: int = 8,
                    in_hw: int = 8, k: int = 3, batch: int = 4,
                    seed: int = 0, device="cuda", **host_kw):
    """A uniform stride-1 conv chain: the most shape sharing between
    probes, the case the probe engine (and its fan-out) is for."""
    import torch

    from repro_torch.device import resolve
    from repro_torch.models import cnn, cnn_host
    from repro_torch.models.cnn import ConvNet, ConvSpec

    device = resolve(device)
    specs = [ConvSpec(3, width, k, 1, act="relu")]
    specs += [ConvSpec(width, width, k, 1, act="relu")
              for _ in range(L - 1)]
    net = ConvNet(tuple(specs), (), in_hw=in_hw, in_ch=3,
                  head="classifier", num_classes=4)
    params = cnn.init_params(net, torch.Generator().manual_seed(seed),
                             device=device)
    return cnn_host.CNNHost(net, params, batch=batch, max_span=max_span,
                            device=device, **host_kw), params


def cli_host(*, arch: str, seed: int = 0, batch: int = 8, seq: int = 128,
             full: bool = False, max_span=None, device="cuda"):
    """The ``python -m repro_torch.compress`` networks, so the CLI's
    ``--workers N`` builds go through the same spec protocol."""
    from repro_torch.compress import build_host

    host, _source = build_host(arch, seed=seed, batch=batch, seq=seq,
                               full=full, max_span=max_span, device=device)
    return host, host.params
