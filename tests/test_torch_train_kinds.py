"""One train step of the port against the reference's for the MoE
(granite-moe-1b-a400m, whose aux loss enters the loss), recurrent
(mamba2-780m, recurrentgemma-2b), encoder (hubert-xlarge: frames in,
a label per frame) and VLM (internvl2-1b: the loss on text positions
only) archs, at SMOKE in f32 on the CPU, with the helpers and bounds of
`test_torch_train_archs.py`."""

import pytest
import torch

from repro_torch.configs import get_config
from test_torch_train_archs import (assert_metrics_close, assert_state_close,
                                    step_both)

ARCHS = ("granite-moe-1b-a400m", "mamba2-780m", "recurrentgemma-2b",
         "hubert-xlarge", "internvl2-1b")


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch):
    got, got_m, want, want_m = step_both(arch)
    assert_metrics_close(got_m, want_m)
    assert int(got["opt"]["step"]) == 1
    assert_state_close(got, want)
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:   # the balance loss is on and weighted in
        assert float(got_m["aux"]) > 0
        torch.testing.assert_close(
            got_m["loss"], got_m["ce"] + 0.01 * got_m["aux"])
