"""The port's examples (``examples/pt_*.py``) against the reference's
(``examples/*.py``).

* ``quickstart`` and ``similarity_search`` run as subprocesses in both
  packages (the port with ``--device cpu``); their printed lines are equal
  once times, the temporary directory's name and the server's split of
  requests between its cache and in-flight dedup (which the threads' timing
  decides) are stripped.
* ``serve_batch`` and ``train_lm`` run in-process at small sizes, the port
  on the reference's weights: the example's ``init_params`` /
  ``init_train_state`` is patched to load the reference's draw from
  ``jax.random.PRNGKey(0)`` (``repro_torch.convert``).  Served tokens are
  equal; the first steps' losses are within 1e-5 relative (the train-step
  parity tests' tolerance: two frameworks' float32 summation orders).
  Three steps cannot lower the loss by 1.0, so both examples' own final
  assert fails there, as it must.
"""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from _torch_lm import np_tree

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
LOSS_RTOL = 1e-5


def load(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(name, *args):
    out = subprocess.run([sys.executable, os.path.join("examples", f"{name}.py"), *args],
                         cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def normalised(text):
    text = re.sub(r"in [0-9.]+ ms", "in <t> ms", text)
    text = re.sub(r"recovered from \S+:", "recovered from <dir>:", text)
    return re.sub(r"(requests: )\d+ executions \(.*\)", r"\1<split>", text)


@pytest.mark.parametrize("name", ["quickstart", "similarity_search"])
def test_script_examples_print_the_reference_lines(name):
    port = run_script(f"pt_{name}", "--device", "cpu")
    ref = run_script(name)
    assert normalised(port) == normalised(ref)
    assert port.count("OK") == ref.count("OK") >= 2
    if name == "quickstart":
        assert "on sale in 2..10 stores       :   5667 products" in port


def _ref_lm_params(cfg):
    """The reference's ``init_params(cfg, PRNGKey(0))`` for the port's
    ``cfg`` (both packages hold the same config fields), as numpy."""
    from repro.configs import get_config as r_config
    from repro.models import init_params as r_init

    base = r_config("qwen3-1.7b", reduced=True)
    rcfg = dataclasses.replace(base, **{f.name: getattr(cfg, f.name)
                                        for f in dataclasses.fields(base)})
    return rcfg, r_init(rcfg, jax.random.PRNGKey(0))


def test_serve_batch_tokens_equal_reference(monkeypatch, capsys):
    from repro_torch.convert import lm_params_from_reference

    args = ["--requests", "5", "--slots", "2", "--max-new", "4"]
    ref = load("serve_batch")
    ref.main(args)
    want = capsys.readouterr().out

    port = load("pt_serve_batch")
    monkeypatch.setattr(port, "init_params", lambda cfg, seed, device: lm_params_from_reference(
        np_tree(_ref_lm_params(cfg)[1]), cfg, device=device))
    port.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    strip = lambda s: re.sub(r", [0-9.]+ tok/s", "", s)  # noqa: E731
    assert strip(got) == strip(want)
    assert got.count("  rid ") == 5 and got.endswith("OK\n")


def test_train_lm_first_losses_equal_reference(monkeypatch, tmp_path, capsys):
    from repro.train import init_train_state as r_init_state
    from repro_torch.convert import train_state_from_reference

    args = ["--steps", "3", "--width", "64", "--layers", "2", "--batch", "2", "--seq", "16",
            "--vocab", "256"]

    ref = load("train_lm")
    ref_losses = []
    real_jit = jax.jit

    def recording_jit(fn, **kw):
        step = real_jit(fn, **kw)

        def call(state, batch):
            state, metrics = step(state, batch)
            ref_losses.append(float(metrics["loss"]))
            return state, metrics
        return call

    monkeypatch.setattr(ref, "jax", types.SimpleNamespace(jit=recording_jit, random=jax.random))
    with pytest.raises(AssertionError, match="loss did not improve"):
        ref.main(args + ["--ckpt-dir", str(tmp_path / "ref")])

    port = load("pt_train_lm")
    port_losses = []
    real_make = port.make_train_step

    def recording_make(cfg, tc):
        step = real_make(cfg, tc)

        def call(state, batch):
            state, metrics = step(state, batch)
            port_losses.append(float(metrics["loss"]))
            return state, metrics
        return call

    def ref_state(cfg, seed, device):
        rcfg, _ = _ref_lm_params(cfg)
        return train_state_from_reference(np_tree(r_init_state(rcfg, jax.random.PRNGKey(seed))),
                                          cfg, device=device)

    monkeypatch.setattr(port, "make_train_step", recording_make)
    monkeypatch.setattr(port, "init_train_state", ref_state)
    with pytest.raises(AssertionError, match="loss did not improve"):
        port.main(args + ["--ckpt-dir", str(tmp_path / "pt"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(port_losses) == len(ref_losses) == 3
    np.testing.assert_allclose(port_losses, ref_losses, rtol=LOSS_RTOL)
    assert "(latest step 3)" in out and os.path.isdir(tmp_path / "pt" / "step_00000003")


def test_train_lm_default_checkpoint_directory_is_the_ports_own():
    port = load("pt_train_lm")
    assert os.path.basename(port.DEFAULT_CKPT_DIR) == "repro_torch_train_lm"
    assert port.DEFAULT_CKPT_DIR != "/tmp/repro_train_lm"  # examples/train_lm.py's default


@pytest.mark.parametrize("name", ["pt_quickstart", "pt_serve_batch", "pt_similarity_search",
                                  "pt_train_lm"])
def test_examples_refuse_to_run_without_a_card(name):
    if torch.cuda.is_available():  # decided inside the test, not at import
        pytest.skip("a CUDA device is present: this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        load(name).main([])
