"""The port's LM data pipeline (``repro_torch.data.pipeline``) draws the
reference's numpy values: arrays equal, dtypes equal, for every step, host
shard and front-end."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as r_config
from repro.data import DataConfig as RDataConfig
from repro.data import arch_batch as r_arch_batch
from repro.data import lm_batch as r_lm_batch
from repro.data import lm_batches as r_lm_batches
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, arch_batch, lm_batch, lm_batches


def _equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu", k
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("kw", [
    dict(vocab=512, batch=8, seq=128),
    dict(vocab=151936, batch=8, seq=128, seed=3),
    dict(vocab=64, batch=6, seq=31, n_hosts=3, host_id=2),  # odd seq: the copy half
])
def test_lm_batch_equal(kw):
    for step in (0, 1, 7, 123):
        _equal(lm_batch(DataConfig(**kw), step, device="cpu"), r_lm_batch(RDataConfig(**kw), step))


def test_lm_batches_stream_equal():
    kw = dict(vocab=300, batch=4, seq=16, seed=9)
    got = itertools.islice(lm_batches(DataConfig(**kw), 5, device="cpu"), 3)
    want = itertools.islice(r_lm_batches(RDataConfig(**kw), 5), 3)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_batch_equal(arch):
    """Tokens and labels; the audio features; the vision patches and mask."""
    for reduced, (b, s) in ((True, (3, 24)), (False, (2, 300))):
        rcfg, tcfg = r_config(arch, reduced=reduced), get_config(arch, reduced=reduced)
        got = arch_batch(tcfg, b, s, "train", seed=4, device="cpu")
        _equal(got, r_arch_batch(rcfg, b, s, "train", seed=4))
        if tcfg.frontend == "vision":
            assert not got["mask"][:, : tcfg.frontend_tokens].any()
            assert got["mask"][:, tcfg.frontend_tokens:].all()


def test_lm_batch_default_device_is_the_card():
    """``device=None`` is the CUDA card: without one it raises."""
    if torch.cuda.is_available():
        out = lm_batch(DataConfig(vocab=64, batch=2, seq=8), 0)
        assert out["tokens"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_batch(DataConfig(vocab=64, batch=2, seq=8), 0)
