"""Shared helpers of the tests/test_torch_lm_*.py parity tests.

The reference's params (``jax.random`` init, then perturbed with numpy
noise so that the all-ones norms and all-zero mixes are exercised too)
go to both packages as numpy arrays; inputs are made with numpy from a
seed.  Everything runs in float32 on the CPU.
"""
import jax
import numpy as np
import torch

from repro_torch.convert import _PARAM_NAMES
from repro_torch.models.layers import Init


def np_tree(tree):
    """A JAX pytree as numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def perturb(tree, seed: int, scale: float = 0.1):
    """Every float leaf plus N(0, scale) noise, as numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=np.shape(a))).astype(np.float32),
        tree,
    )


def module_from(cls, cfg, np_params):
    """A port block module (``layers.Attention``, ``rglru.RGLRU``, ...)
    holding the given reference params."""
    mod = cls(cfg, Init(0, torch.device("cpu"), torch.float32))
    with torch.no_grad():
        for name, arr in np_params.items():
            getattr(mod, _PARAM_NAMES.get(name, name)).copy_(torch.tensor(np.asarray(arr)))
    return mod


def t(x, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU tensor (a copy)."""
    out = torch.tensor(np.asarray(x))
    return out if dtype is None else out.to(dtype)


def close(got, want, atol: float, rtol: float):
    """``got`` (tensor) allclose to ``want`` (jax / numpy array)."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy() if got.is_floating_point() else got.numpy()
    np.testing.assert_allclose(got, np.asarray(want, dtype=got.dtype), atol=atol, rtol=rtol)
