"""The A/B tool's per-side script, which carries the source of the port's
``profiling.device_span_ms``, compiles without a card."""

from whisper_flamingo_tpu_torch.tools import dtw_mlp_ab


def test_ab_side_script_compiles_with_the_helper():
    code = compile(dtw_mlp_ab.side_script(), "<dtw_mlp_ab side>", "exec")
    assert {"device_span_ms", "span_us"} <= set(code.co_names)
