"""The port's probes: command-line programs that time one kernel of the
port on the card (``python -m whisper_flamingo_tpu_torch.tools.<name>``)."""
