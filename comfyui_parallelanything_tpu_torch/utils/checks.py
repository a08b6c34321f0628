"""NaN/Inf assertions on a forward's outputs (counterpart of
``comfyui_parallelanything_tpu/utils/checks.py``).

The JAX module checks inside the compiled program with ``checkify`` and raises on
the host through ``err.throw()``. Eager PyTorch has no program to check inside: the
port checks the outputs after the forward, on the device, and reads back one flag
per tensor, raising the same ``ValueError`` on the host instead of letting NaN/Inf
become black images.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def assert_finite(tree: Any, name: str = "output") -> None:
    """Raise ``ValueError`` naming the first floating-point tensor leaf of ``tree``
    that holds a NaN or an Inf (a host read of one flag per leaf)."""
    for i, leaf in enumerate(_leaves(tree)):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise ValueError(f"{name}[leaf {i}] contains NaN/Inf")


def checked(fn: Callable[..., Any], name: str = "forward") -> Callable[..., Any]:
    """Wrap ``fn`` so its outputs are finite-checked after every call; raises
    ``ValueError`` on the host when the check trips.

    Usage::

        model_checked = checked(model, "flux forward")
        out = model_checked(x, t, ctx)   # raises on NaN/Inf output
    """

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, name)
        return out

    return wrapper
