"""Small shapes for the benchmark's CPU tests: the cells' configurations
with the ``debug`` widths (and a small BERT), so that a whole run of a cell
fits a test."""

import copy
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

DEBUG_DIMS = {"n_mels": 80, "n_audio_ctx": 1500, "n_audio_state": 64, "n_audio_head": 2,
              "n_audio_layer": 2, "n_vocab": 51865, "n_text_ctx": 448, "n_text_head": 2,
              "n_text_state": 64, "n_text_layer": 2}
DEBUG_BERT = {"vocab_size": 1024, "hidden_size": 48, "num_hidden_layers": 2,
              "num_attention_heads": 2, "intermediate_size": 96}


def small_config(name: str) -> dict:
    from perfbench import spec

    cfg = copy.deepcopy(spec.config(name))
    cfg["dims"] = dict(DEBUG_DIMS)
    if "bert" in cfg:
        cfg["bert"] = dict(cfg["bert"], **DEBUG_BERT)
        cfg["extras"]["bert_dim"] = DEBUG_BERT["hidden_size"]
    return cfg


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
