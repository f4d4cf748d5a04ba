"""The JAX package's example scripts (``examples/demo.py``,
``examples/eval_table.py``) as modules of the port:

    python -m whisper_flamingo_tpu_torch.examples.demo [--model debug] [--platform cpu]
    python -m whisper_flamingo_tpu_torch.examples.eval_table [--model-type small] ...

They take the JAX scripts' flags (``--platform cpu`` asks for the CPU; the
card is the default) and print the same lines; each ``main(argv)`` returns
its rows.
"""
