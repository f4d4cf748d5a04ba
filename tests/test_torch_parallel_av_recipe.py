"""``av_train`` under a 2 x 2 mesh: its smoke config (the debug Whisper
and trunk) as 4 gloo ranks under ``torchrun`` on the CPU gives the
one-device per-step losses to 1e-4 relative (the helper and reasoning of
``test_torch_parallel_text_recipes.py``; the modality draw comes from one
seeded generator per rank, the same on every rank)."""

import numpy as np
import pytest
import torch

from test_torch_parallel_text_recipes import recipe_losses


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_av_train_under_a_2x2_mesh_equals_one_device(tmp_path):
    one = recipe_losses(tmp_path, "av_train", "av", 1)
    mesh = recipe_losses(tmp_path, "av_train", "av", 4)
    assert sorted(mesh) == sorted(one) and one
    for step in one:
        np.testing.assert_allclose(mesh[step], one[step], rtol=1e-4, err_msg=str(step))
