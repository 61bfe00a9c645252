"""``main_nerf -O`` end to end on the CPU with the default eval renderer
(``iter``): test_torch_train.py's check, in a file of its own so that
pytest-xdist's ``--dist loadfile`` runs it beside the ``oneshot`` case."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train import check_main_nerf_trains_resumes_and_serves  # noqa: E402


@pytest.mark.parametrize("eval_renderer", ["iter"])
def test_main_nerf_trains_resumes_and_serves(tmp_path, eval_renderer):
    check_main_nerf_trains_resumes_and_serves(tmp_path, eval_renderer)
