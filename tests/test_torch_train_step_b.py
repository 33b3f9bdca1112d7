"""One train step of the port against the reference's: the last five of
the ten architectures (recurrentgemma, rwkv6, mixtral, granite-moe,
hubert).

The shared run and its tolerances are in ``tests/_torch_train.py``: the
reference's ``value_and_grad`` + ``apply_updates`` against the port's
``make_train_step`` from one state on one ``arch_batch``, float32 on the
CPU."""
import pytest

from _torch_train import (
    check_every_gradient_leaf,
    check_loss_aux_and_metrics,
    check_state_after_the_update,
)
from repro.configs import ARCHS

STEP_ARCHS = ARCHS[5:]


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_loss_aux_and_metrics(arch):
    check_loss_aux_and_metrics(arch)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_every_gradient_leaf(arch):
    check_every_gradient_leaf(arch)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_state_after_the_update(arch):
    check_state_after_the_update(arch)
