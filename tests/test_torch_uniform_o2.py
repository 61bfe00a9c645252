"""``main_nerf -O2`` (c2f stages and P = 2, patches, TV) end to end on the
CPU: test_torch_uniform.py's check, in a file of its own so that
pytest-xdist's ``--dist loadfile`` runs it beside the uniform case."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_uniform import check_main_nerf_trains_the_new_modes  # noqa: E402


@pytest.mark.parametrize("mode", ["O2"])
def test_main_nerf_trains_the_new_modes(tmp_path, mode):
    check_main_nerf_trains_the_new_modes(tmp_path, mode)
