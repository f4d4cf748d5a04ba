"""The port's distillation steps under a 2 x 2 mesh of gloo ranks on the
CPU: TransKD against the JAX package's step under its mesh, prompt-KD
against JAX's step on one device, both against one rank (the helpers and
tolerances of ``test_torch_parallel_train.py``). The English vocabulary
splits, so the KL reads logits gathered over the model axis."""

import pytest
import torch

from test_torch_parallel_train import TINY_EN, check_replicated_bit_equal, check_step, run_cases

CASES = {
    "kd_2x2": ("kd", TINY_EN, {}, (2, 2), 4, None, {}),
    "prompt_kd_2x2": ("prompt_kd", TINY_EN, {}, (2, 2), 4, None, {"prompt": True}),
}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("parallel_kd"), CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_distillation_step_matches_jax_and_one_rank(runs, name):
    check_step(runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_gradients_are_bit_equal_across_a_model_row(runs, name):
    check_replicated_bit_equal(runs, name)
