"""The per-round learning rate at negative rounds: FedAvg's final fine-tune
runs at round -1, where the reference computes ``lr * lr_decay**-1`` (an
integer power with a negative exponent: the reciprocal of the repeated
squaring), not the end-of-training rate."""

import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.config import OptimConfig as JOptim
from neuroimagedisttraining_tpu.core.optim import round_lr as jround_lr
from neuroimagedisttraining_tpu_torch.config import OptimConfig
from neuroimagedisttraining_tpu_torch.core.optim import round_lr

ROUNDS = [-3, -1, 0, 1, 7, 199]


@pytest.mark.parametrize("lr_decay", [0.998, 0.95])
def test_round_lr_bit_equal_at_negative_rounds(lr_decay):
    """Bit-equal to the reference at every round of ``ROUNDS``."""
    ref = np.asarray([jround_lr(JOptim(lr_decay=lr_decay), r)
                      for r in ROUNDS], dtype=np.float32)
    port = np.asarray([round_lr(OptimConfig(lr_decay=lr_decay), r,
                                torch.device("cpu")).numpy() for r in ROUNDS])
    np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32))


def test_finetune_lr_is_lr_over_decay():
    """At the defaults round -1 gives float32 0.01002004 (= 0.01 / 0.998),
    above the initial rate."""
    got = round_lr(OptimConfig(), -1, torch.device("cpu"))
    assert got.dtype == torch.float32
    assert got.numpy().view(np.int32) == np.float32(0.01002004).view(np.int32)
    assert float(got) > OptimConfig().lr
