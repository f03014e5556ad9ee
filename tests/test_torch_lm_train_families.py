"""LM training parity for the families of the larger smoke configs
(hybrid, encdec, vlm): ``check_loss_curve`` of tests/test_torch_lm_train.py
(its docstring states the tolerances), in a file of its own to keep each
file's CPU time short."""
import pytest

from test_torch_lm_train import check_loss_curve


@pytest.mark.parametrize("family", ["hybrid", "encdec", "vlm"])
def test_loss_curve_matches_reference(family):
    check_loss_curve(family)
