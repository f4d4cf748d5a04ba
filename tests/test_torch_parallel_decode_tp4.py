"""TP 4 decode at large-v2 proportions (the JAX package's
``test_tp_decode_large_v2_proportions`` case): 20 heads (5 a rank), MLP
5,120 (1,280 a rank), 2 layers, audio context 96, the odd 51,865-token
vocabulary replicated. Four gloo ranks on a 1 x 4 mesh against one rank
and against JAX's decode on its 2 x 4 mesh (the helpers of
``test_torch_parallel_decode.py``)."""

import numpy as np
import pytest
import torch

from test_torch_parallel_decode import _mel, _opts, check_jax, check_one_rank, run_cases

LARGE_V2_TP = dict(n_mels=80, n_audio_ctx=96, n_audio_state=1280, n_audio_head=20,
                   n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=20,
                   n_text_state=1280, n_text_layer=2)
CASES = {"large_v2_tp4": (LARGE_V2_TP, {}, (1, 4), _opts(sample_len=4), _mel(2, 192, 0),
                          (2, 4), {})}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("parallel_decode_tp4"), CASES)


def test_tp4_decode_equals_one_rank(runs):
    check_one_rank(runs, "large_v2_tp4")


def test_tp4_decode_equals_jax(runs):
    check_jax(runs, "large_v2_tp4")
    assert np.isfinite(runs[0]["large_v2_tp4"][0][0][1])
